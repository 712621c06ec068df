"""radar_signal_process_tpu_torch — the PyTorch + CUDA port for an NVIDIA H100.

A second implementation of ``radar_signal_process_tpu`` beside it, with the
same layout so each module's counterpart is found by name:

* ``config`` / ``device`` / ``params`` — profiles (shared with the JAX
  package), the device and float policy, and the chain's constants as
  tensors;
* ``ops``     — plain PyTorch DSP ops (FFT pulse compression, Doppler
  processing, notch, CA-CFAR, detection lists, DBF);
* ``kernels`` — hand-written Hopper CUDA kernels (B1 cascaded CFAR, B2 RDM
  former), each with its plain PyTorch version beside it;
* ``models``  — the G2 windowed stream: frame processor, detector and the
  streaming pipeline;
* ``cli``     — ``python -m radar_signal_process_tpu_torch.cli stream``.

The port imports ``torch`` and never ``jax``.  Framework-free host code of
the JAX package (profiles, ``.bin`` ingest, counters) is imported from it
rather than copied.
"""

__version__ = "0.1.0"

"""radar_signal_process_tpu_torch — the PyTorch + CUDA port for an NVIDIA H100.

A second implementation of ``radar_signal_process_tpu`` beside it, with the
same layout so each module's counterpart is found by name:

* ``config`` / ``device`` / ``params`` — profiles, the device and float
  policy, and the chain's constants as tensors;
* ``ingest`` / ``sim`` / ``utils`` — ``.bin`` readers (numpy and native
  C++), the capture writers, pipeline counters;
* ``ops``     — plain PyTorch DSP ops (FFT pulse compression, Doppler
  processing, notches, CA-CFAR, detection lists and measurement, spectral
  width, DBF, calibration tables);
* ``kernels`` — hand-written Hopper CUDA kernels (B1 cascaded CFAR, B2 RDM
  former, B3 fused PC + RDM former), each with its plain PyTorch version
  beside it;
* ``models``  — the G2 windowed stream (frame processor, detector,
  streaming pipeline) and the G0 dual-beam chain;
* ``cli``     — ``python -m radar_signal_process_tpu_torch.cli stream|dmx``.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package: the host code it shares with it (profiles, ``.bin`` ingest, capture
writers, calibration tables, counters) is its own copy, which the tests hold
equal to the JAX package's.  Entry points run on the card unless the caller
asks for the CPU.
"""

__version__ = "0.1.0"

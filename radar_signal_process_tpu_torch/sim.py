"""Synthetic G2 and G1 captures, written by the JAX package's packet writer.

``radar_signal_process_tpu/sim/packets_synth.py`` imports only the profiles
and the capture file names, but importing it as a module first runs
``radar_signal_process_tpu/sim/__init__.py``, which imports jax.  This
module loads that one file by path and re-exports its writers, so the port
writes byte-identical captures without jax.
"""

from __future__ import annotations

from radar_signal_process_tpu_torch._reference import load_reference_module

_packets_synth = load_reference_module("sim/packets_synth.py")
write_g2_capture = _packets_synth.write_g2_capture
write_g1_capture = _packets_synth.write_g1_capture

"""Synthetic G2 captures, written by the JAX package's packet writer.

``radar_signal_process_tpu/sim/packets_synth.py`` imports only the profiles
and the capture file names, but importing it as a module first runs
``radar_signal_process_tpu/sim/__init__.py``, which imports jax.  This
module loads that one file by path and re-exports its writer, so the port
writes byte-identical captures without jax.
"""

from __future__ import annotations

import importlib.util
import pathlib

import radar_signal_process_tpu.config as _reference_config

_PACKETS_SYNTH = pathlib.Path(_reference_config.__file__).parent / "sim" / "packets_synth.py"


def _load_packets_synth():
    spec = importlib.util.spec_from_file_location(
        "radar_signal_process_tpu_torch._packets_synth", _PACKETS_SYNTH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


write_g2_capture = _load_packets_synth().write_g2_capture

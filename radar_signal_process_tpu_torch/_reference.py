"""Load one framework-free file of the JAX package by path.

Some modules of ``radar_signal_process_tpu`` use only numpy (the capture
writer, the calibration tables), but importing them as package modules
first runs a package ``__init__`` that imports jax.  Loading the one file by
path gives the port the same code without jax.
"""

from __future__ import annotations

import importlib.util
import pathlib
from types import ModuleType

import radar_signal_process_tpu.config as _reference_config

REFERENCE_ROOT = pathlib.Path(_reference_config.__file__).parent


def load_reference_module(relpath: str) -> ModuleType:
    """``radar_signal_process_tpu/<relpath>`` as a private module of the port."""
    name = "radar_signal_process_tpu_torch._ref_" + relpath.removesuffix(".py").replace("/", "_")
    spec = importlib.util.spec_from_file_location(name, REFERENCE_ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

"""Hardware calibration tables: monopulse K values and the frequency plan.

The JAX package's ``ops/tables.py`` is numpy only (calibration data from
``CFAR_WangCai/angle_KvalueGen.m`` and ``freValueGen.m``), but its package
``__init__`` imports jax, so the port loads that one file by path: one copy
of the data serves both packages.
"""

from radar_signal_process_tpu_torch._reference import load_reference_module

_tables = load_reference_module("ops/tables.py")
angle_k_values = _tables.angle_k_values  # (11 frequency points, 12 beam positions)
freq_value = _tables.freq_value          # frequency index -> carrier [Hz]

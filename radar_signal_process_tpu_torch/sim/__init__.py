"""Simulation harness: capture writers, synthetic targets, clutter, SCR control.

The port's own copy of the JAX package's ``sim`` (framework-free numpy):

* ``packets_synth`` — byte-level G2/G1 capture writers
  (``write_g2_capture``, ``write_g1_capture``);
* ``targets`` / ``clutter`` / ``scr`` — reference components S1-S3
  (SURVEY.md §2.3): a synthetic moving target at a known (range, velocity)
  injected into clutter at a controlled signal-to-clutter ratio
  (``MatlabProcess_xuzerui/main.m:184-280``).
"""

from radar_signal_process_tpu_torch.sim.clutter import add_clutter, synthetic_clutter  # noqa: F401
from radar_signal_process_tpu_torch.sim.packets_synth import (  # noqa: F401
    write_g1_capture,
    write_g2_capture,
)
from radar_signal_process_tpu_torch.sim.scr import apply_scr  # noqa: F401
from radar_signal_process_tpu_torch.sim.targets import (  # noqa: F401
    synthesize_scene,
    synthesize_target_echo,
)

"""Utilities: frame manifests, the MATLAB ``.mat`` bus, dataset helpers,
counters, logging and per-stage timers.

``logging``, ``manifest``, ``matbus`` and ``dataset`` are the port's own
copies of the JAX package's numpy modules (``tests/test_torch_import.py``
holds them equal); ``profiling.StageTimers`` fences the card, and
``profiling.span`` marks the hot paths' steps while a profiler runs.
"""

from radar_signal_process_tpu_torch.utils.manifest import (  # noqa: F401
    save_frame,
    load_frame,
    frame_exists,
)
from radar_signal_process_tpu_torch.utils.logging import Counters, get_logger  # noqa: F401
from radar_signal_process_tpu_torch.utils.profiling import StageTimers  # noqa: F401

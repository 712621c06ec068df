"""Detection-quality evaluation (reference S4, ``main_cfar.m:163-279``).

``metrics`` is the port's copy of the JAX package's numpy metrics;
``sweep`` runs the threshold x SCR sweep through the port's chain (B2 and
B1 on the card).
"""

from radar_signal_process_tpu_torch.evalx.metrics import (  # noqa: F401
    TruthGate,
    accuracy,
    detection_rate,
    evaluate_frames,
    false_alarm_rate,
    localization_pcf,
)

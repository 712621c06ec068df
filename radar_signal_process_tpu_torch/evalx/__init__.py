"""Detection-quality evaluation (reference S4, ``main_cfar.m:163-279``).

``metrics`` and ``gps`` are the port's copies of the JAX package's numpy
metrics and differential-GPS comparison; ``sweep`` runs the threshold x SCR
sweep through the port's chain (B2 and B1 on the card).
"""

from radar_signal_process_tpu_torch.evalx.metrics import (  # noqa: F401
    TruthGate,
    accuracy,
    detection_rate,
    evaluate_frames,
    false_alarm_rate,
    localization_pcf,
)
from radar_signal_process_tpu_torch.evalx.gps import (  # noqa: F401
    GPSTrack,
    compare_estimates,
    drop_invalid,
    gps_frame_indices,
    read_gps_track,
)

"""Signal-to-clutter-ratio control (``MatlabProcess_xuzerui/fun_SCR.m``).

The port's own copy of the JAX package's ``sim/scr.py`` (numpy only).

Per pulse segment, the simulated echo is scaled so its power relative to the
measured clutter power matches the requested SCR; the narrow segment gets a
+10 dB boost (``fun_SCR.m:174``).  Power is measured as mean |x|^2 (the
reference computes ``mean(x.^2)`` on complex data — a complex quantity; the
intended magnitude power is used here, a deliberate and documented fix).
"""

from __future__ import annotations

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile


def apply_scr(
    echo_sim: np.ndarray,
    clutter: np.ndarray,
    scr_db: float,
    profile: RadarProfile,
) -> np.ndarray:
    """Scale ``echo_sim`` per segment and per PRT to hit ``scr_db`` vs clutter."""
    out = echo_sim.copy()
    scr_linear = (
        10.0 ** ((scr_db + 10.0) / 10.0),  # narrow segment: +10 dB
        10.0 ** (scr_db / 10.0),
        10.0 ** (scr_db / 10.0),
    )
    for (start, npts), scr in zip(
        zip(profile.segment_starts, profile.segment_points), scr_linear
    ):
        seg = slice(start, start + npts)
        p_sig = np.mean(np.abs(echo_sim[0, seg]) ** 2) + np.finfo(np.float64).eps
        p_clutter = np.mean(np.abs(clutter[:, seg]) ** 2, axis=1)
        gain = np.sqrt(p_clutter * scr / p_sig)
        out[:, seg] = echo_sim[:, seg] * gain[:, None]
    return out

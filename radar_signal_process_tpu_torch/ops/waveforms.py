"""Reference transmit-waveform synthesis (host numpy constants).

Port of ``radar_signal_process_tpu/ops/waveforms.py::reference_pulses``:
the ideal LFM pulses of ``MTD/fun_MTD_produce.m:61-69`` — time axis
``t = -tau/2 : ts : tau/2 - ts``, narrow pulse ``sin(2*pi*t + pi/2)``,
chirped pulses ``exp(j*2*pi*(0.5*K*t^2))``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile


def reference_pulses(profile: RadarProfile) -> Tuple[np.ndarray, ...]:
    """Per-pulse reference waveforms (complex128) for matched filtering."""
    ts = profile.ts
    pulses = []
    for tau, k_slope, sign in zip(
        profile.pulse_widths, profile.chirp_slopes, profile.chirp_signs
    ):
        n = int(round(tau / ts))
        t = (np.arange(n) * ts) - tau / 2.0
        if sign == 0:
            pulses.append(np.sin(2.0 * np.pi * t + np.pi / 2.0).astype(np.complex128))
        else:
            pulses.append(np.exp(1j * 2.0 * np.pi * (0.5 * k_slope * t**2)))
    return tuple(pulses)

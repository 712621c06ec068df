"""Synthetic point-target echo generation.

The port's own copy of the JAX package's ``sim/targets.py`` (numpy only).

The reference calls a (missing) ``fun_SimulateTarget`` to build the moving
target used by its validation driver (``main.m:186-189``: V = -5.7 m/s,
R = 320 m).  This module supplies that capability: a point target at range R
and radial velocity V produces, in each pulse segment, a copy of that
segment's transmit pulse delayed by the round-trip time and rotated by the
per-PRT Doppler phase.

Sign conventions are chosen so that the target lands at velocity ~V on the
framework's shifted velocity axis ``v = linspace(-prf/2, prf/2, N) * lambda/2``
(``fun_MTD_produce.m:127-129``) and at range column ``round(R / delta_r)``
within each segment after the pulse-compression alignment extraction.
"""

from __future__ import annotations

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses


def synthesize_target_echo(
    profile: RadarProfile,
    velocity_ms: float,
    range_m: float,
    n_pulses: int | None = None,
    amplitude: float = 1.0,
    initial_phase: float = 0.0,
) -> np.ndarray:
    """Echo matrix (n_pulses, point_prt) of a single point target."""
    n_pulses = n_pulses or profile.prt_per_frame
    pulses = reference_pulses(profile)
    d = int(round(range_m / profile.delta_r))  # range cell within each segment

    # Doppler frequency: fd = 2 V / lambda; the slow-time phase ramp
    # exp(+j 2 pi fd m PRT) places the peak at +V on the shifted axis.
    fd = 2.0 * velocity_ms / profile.wavelength
    m = np.arange(n_pulses)
    slow_phase = np.exp(1j * (2.0 * np.pi * fd * m * profile.prt + initial_phase))

    echo = np.zeros((n_pulses, profile.point_prt), dtype=np.complex128)
    for start, npts, pulse in zip(
        profile.segment_starts, profile.segment_points, pulses
    ):
        if d >= npts:
            continue  # target beyond this segment's unambiguous window
        span = min(len(pulse), npts - d)
        echo[:, start + d : start + d + span] += (
            amplitude * slow_phase[:, None] * pulse[None, :span]
        )
    return echo


def synthesize_scene(
    profile: RadarProfile,
    targets,  # iterable of (velocity_ms, range_m, amplitude)
    n_pulses: int | None = None,
    seed: int = 0,
) -> np.ndarray:
    """Superpose multiple point targets with random initial phases."""
    n_pulses = n_pulses or profile.prt_per_frame
    rng = np.random.default_rng(seed)
    echo = np.zeros((n_pulses, profile.point_prt), dtype=np.complex128)
    for v, r, a in targets:
        echo += synthesize_target_echo(
            profile, v, r, n_pulses, amplitude=a,
            initial_phase=float(rng.uniform(0, 2 * np.pi)),
        )
    return echo

"""Clutter injection and synthetic clutter generation.

The port's own copy of the JAX package's ``sim/clutter.py`` (numpy only).

``add_clutter`` replicates ``fun_add_clutter.m:5-10`` (measured echo rows added
onto the simulated target rows).  ``synthetic_clutter`` stands in for the
measured captures that are absent from the reference snapshot: complex
Gaussian noise plus strong stationary (zero-Doppler) discrete scatterers,
giving the zero-velocity ridge the clutter notch must remove.
"""

from __future__ import annotations

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile


def add_clutter(echo_sim: np.ndarray, clutter: np.ndarray) -> np.ndarray:
    """Add clutter rows onto the simulated echo (truncating to sim width)."""
    n_prt, n_pts = echo_sim.shape
    return echo_sim + clutter[:n_prt, :n_pts]


def synthetic_clutter(
    profile: RadarProfile,
    n_pulses: int | None = None,
    noise_power: float = 1.0,
    n_scatterers: int = 12,
    scatterer_power: float = 400.0,
    seed: int = 0,
) -> np.ndarray:
    """Noise + stationary discrete clutter, (n_pulses, point_prt) complex."""
    n_pulses = n_pulses or profile.prt_per_frame
    rng = np.random.default_rng(seed)
    scale = np.sqrt(noise_power / 2.0)
    out = scale * (
        rng.standard_normal((n_pulses, profile.point_prt))
        + 1j * rng.standard_normal((n_pulses, profile.point_prt))
    )
    cells = rng.choice(profile.point_prt, size=n_scatterers, replace=False)
    amps = np.sqrt(scatterer_power) * (0.5 + rng.random(n_scatterers))
    phases = np.exp(1j * 2 * np.pi * rng.random(n_scatterers))
    for c, a, p in zip(cells, amps, phases):
        # stationary: constant phase across pulses (zero Doppler)
        out[:, c] += a * p
    return out

"""Plain constants of the radar chains, rebuilt from a configuration file.

Everything here is derived from the JSON configuration alone (the profile
dict and the tables it carries), in float64 NumPy, after the MATLAB
reference: windows (MATLAB's symmetric variants), the ideal LFM reference
pulses (``MTD/fun_MTD_produce.m:61-69``), the narrow-pulse FIR taps
(``MTD/fun_lss_pulse_compression.m:31-51``) and the notch rows
(``MTD/fun_0v_pressing.m:18-22``, ``CFAR_WangCai/fun_0v_pressing.m``).
"""

from __future__ import annotations

import math

import numpy as np

C_LIGHT = 2.99792458e8


def matlab_round(x: float) -> int:
    """Half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def window(kind: str, n: int, beta: float = 8.0) -> np.ndarray:
    """MATLAB's symmetric ``kaiser(n, beta)`` or ``hamming(n)``, float64."""
    k = np.arange(n)
    if kind == "kaiser":
        x = 2.0 * k / (n - 1) - 1.0
        return np.i0(beta * np.sqrt(1.0 - x * x)) / np.i0(beta)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))
    raise ValueError(f"window {kind!r} not in the reference")


def segment_starts(profile: dict) -> list[int]:
    return [int(s) for s in np.cumsum([0] + list(profile["segment_points"]))[:-1]]


def reference_pulses(profile: dict) -> list[np.ndarray]:
    """One complex128 pulse per segment: ``cos(2 pi t)`` for the narrow
    pulse, ``exp(j pi K t^2)`` with ``K = sign B / tau`` for the chirps, on
    ``t = -tau/2 : ts : tau/2 - ts``."""
    ts = 1.0 / profile["fs"]
    out = []
    for tau, sign in zip(profile["pulse_widths"], profile["chirp_signs"]):
        n = int(round(tau / ts))
        t = np.arange(n) * ts - tau / 2.0
        if sign == 0:
            out.append(np.cos(2.0 * np.pi * t).astype(np.complex128))
        else:
            k = sign * profile["bandwidth"] / tau
            out.append(np.exp(1j * np.pi * k * t * t))
    return out


def shifted_notch_rows(n: int, divisor: int) -> tuple[int, int]:
    """Inclusive rows ``round(n/2) - 1 -+ round(n/divisor)`` of a shifted
    spectrum's zero-velocity notch."""
    half, center = matlab_round(n / divisor), matlab_round(n / 2) - 1
    return center - half, center + half


def clutter_cells(clutter_v: float, wavelength: float, prf: float, n_fft: int) -> int:
    """``floor(MTD_V / deltaV)`` (``main_cfar.m:56-58``)."""
    return int(math.floor(clutter_v / (wavelength * prf / n_fft / 2.0)))

"""Window functions matching the reference's MATLAB window menu.

Port of ``radar_signal_process_tpu/ops/windows.py`` (that module is numpy
only, but its package ``__init__`` imports jax).  The reference offers a
7-way window menu for pulse compression and MTD
(``DMX_SignalProcessing_main_xzr.m:179-198,208-227``) and uses
``kaiser(N,8)`` for the G1/G2 Doppler FFT (``MTD/fun_Process_MTD.m:17-18``).
All windows are the *symmetric* variants, MATLAB's defaults.
"""

from __future__ import annotations

import numpy as np


def make_window(kind: str, n: int, beta: float = 8.0) -> np.ndarray:
    """Symmetric window of length ``n`` as float64 numpy (a host constant)."""
    if n <= 0:
        raise ValueError(f"window length must be positive, got {n}")
    if kind == "kaiser":
        return np.kaiser(n, beta)
    if kind == "hamming":
        return np.hamming(n)
    if kind in ("hann", "hanning"):
        return np.hanning(n)
    if kind == "blackman":
        return np.blackman(n)
    if kind in ("rect", "ones", "none"):
        return np.ones(n, dtype=np.float64)
    if kind == "bohman":
        # bohmanwin(N): (1-|x|)cos(pi|x|) + sin(pi|x|)/pi on x in [-1, 1]
        x = np.abs(np.linspace(-1.0, 1.0, n))
        w = (1.0 - x) * np.cos(np.pi * x) + np.sin(np.pi * x) / np.pi
        w[0] = 0.0
        w[-1] = 0.0
        return w
    if kind == "nuttall":
        # nuttallwin(N): 4-term Blackman-Harris (Nuttall) coefficients
        a = (0.3635819, 0.4891775, 0.1365995, 0.0106411)
        k = np.arange(n) / (n - 1)
        return (
            a[0]
            - a[1] * np.cos(2 * np.pi * k)
            + a[2] * np.cos(4 * np.pi * k)
            - a[3] * np.cos(6 * np.pi * k)
        )
    if kind == "parzen":
        # parzenwin(N): piecewise cubic de la Vallee Poussin window
        half = (n - 1) / 2.0
        x = np.abs(np.arange(n) - half) / (n / 2.0)
        return np.where(
            x <= 0.5,
            1.0 - 6.0 * x**2 * (1.0 - x),
            2.0 * (1.0 - x) ** 3,
        )
    raise ValueError(f"unknown window kind: {kind!r}")

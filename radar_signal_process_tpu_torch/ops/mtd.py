"""Moving-target detection: slow-time Doppler transform, notch, MTI, iSTC.

Port of ``radar_signal_process_tpu/ops/mtd.py``.  The pulse axis is the
second-to-last axis throughout.

Replicated reference semantics (file:line):

* windowed slow-time FFT per range bin, ``fftshift``, magnitude —
  ``MTD/fun_Process_MTD.m:17-36``;
* zero-velocity notch: rows ``round(N/2) +- round(N/divisor)`` (1-based)
  set to zero — ``MTD/fun_0v_pressing.m:18-22``;
* G0 clutter zeroing on the *unshifted* spectrum: rows ``0..n_clutter``
  and ``N-n_clutter..N-1`` — ``DMX_SignalProcessing_main_xzr.m:463-465``;
* MTI: lag-30 two-pulse canceller ``x[n+30] - x[n]`` —
  ``MTD/fun_Process_MTI.m:20-22``;
* iSTC: per-sample gain ``10^(stc/20)`` — ``MTD/fun_iSTC.m:12-15``.
"""

from __future__ import annotations

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import matlab_round


def dft_plane(window: np.ndarray, n_fft: int | None = None, shift: bool = True) -> np.ndarray:
    """(n_fft, len(window)) windowed, optionally fftshift'ed DFT plane,
    complex128 on the host.

    ``n_fft > len(window)`` folds zero-padding into a rectangular plane.  The
    construction of the JAX package's ``ops.mtd._dft_matrix_rect``, so the
    matmul form and the B2 kernel contract against the same numbers.
    """
    n = len(window)
    n_fft = n_fft or n
    w_mat = np.exp(-2j * np.pi * np.arange(n_fft)[:, None] * np.arange(n)[None, :] / n_fft)
    if shift:
        w_mat = np.fft.fftshift(w_mat, axes=0)
    return w_mat * np.asarray(window)[None, :]


def doppler_process(
    pc: torch.Tensor,
    window: np.ndarray,
    n_fft: int | None = None,
    shift: bool = True,
    use_matmul: bool = False,
) -> torch.Tensor:
    """Slow-time transform of ``pc`` (..., n_pulses, n_range) -> magnitude RDM.

    ``use_matmul`` contracts against the windowed DFT plane (the form the
    B2 kernel computes); otherwise a windowed FFT over the pulse axis.
    """
    n_pulses = pc.shape[-2]
    if window.shape[0] != n_pulses:
        raise ValueError(f"window length {window.shape[0]} != n_pulses {n_pulses}")
    if use_matmul:
        dft = torch.as_tensor(
            dft_plane(window, n_fft, shift), dtype=pc.dtype, device=pc.device
        )
        spec = torch.matmul(dft, pc)
    else:
        w = torch.as_tensor(window, dtype=pc.real.dtype, device=pc.device)
        spec = torch.fft.fft(pc * w[:, None], n=n_fft or n_pulses, dim=-2)
        if shift:
            spec = torch.fft.fftshift(spec, dim=-2)
    return spec.abs()


def doppler_process_range_major(
    pc: torch.Tensor, window: np.ndarray, n_fft: int | None = None, shift: bool = True
) -> torch.Tensor:
    """:func:`doppler_process` (FFT form) emitting the RDM in the
    (..., n_range, n_velocity) layout that the ``transposed=True`` CFAR
    forms take: ``doppler_process(pc, window).mT``."""
    n_pulses = pc.shape[-2]
    if window.shape[0] != n_pulses:
        raise ValueError(f"window length {window.shape[0]} != n_pulses {n_pulses}")
    w = torch.as_tensor(window, dtype=pc.real.dtype, device=pc.device)
    spec = torch.fft.fft(pc * w[:, None], n=n_fft or n_pulses, dim=-2).mT
    if shift:
        spec = torch.fft.fftshift(spec, dim=-1)
    return spec.abs()


def notch_rows(n: int, divisor: int) -> tuple[int, int]:
    """Inclusive 0-based rows ``(lo, hi)`` of the zero-velocity notch.

    Centre at 1-based ``round(N/2)`` (0-based ``round(N/2) - 1``), half-width
    ``round(N/divisor)``; ``divisor`` 0/None means no notch, ``(0, -1)``.
    """
    if not divisor:
        return 0, -1
    half_width = matlab_round(n / divisor)
    center = matlab_round(n / 2) - 1
    return center - half_width, center + half_width


def notch_mask(n: int, divisor: int) -> np.ndarray:
    """(n,) float32 keep-mask of the zero-velocity notch (host constant)."""
    lo, hi = notch_rows(n, divisor)
    idx = np.arange(n)
    return (~((idx >= lo) & (idx <= hi))).astype(np.float32)


def zero_velocity_notch(rdm: torch.Tensor, divisor: int = 150) -> torch.Tensor:
    """Zero the Doppler rows around the (shifted) zero-velocity position."""
    mask = torch.as_tensor(
        notch_mask(rdm.shape[-2], divisor), dtype=rdm.dtype, device=rdm.device
    )
    return rdm * mask[:, None]


def zero_velocity_notch_unshifted(
    rdm: torch.Tensor, n_clutter: int, keep: torch.Tensor | None = None
) -> torch.Tensor:
    """G0 clutter zeroing on an unshifted spectrum (velocity axis -2).

    Zeroes rows ``[0 : n_clutter+1]`` and ``[N-n_clutter : N]`` (0-based),
    ``zeroSetFlagMTD = [1:MTD_0_num+1, mtd_FFT_num-MTD_0_num+1 : mtd_FFT_num]``.
    ``keep`` is :func:`notch_mask_unshifted` made once on ``rdm``'s device
    and dtype (so nothing is copied from the host); made here when None.
    """
    if keep is None:
        keep = torch.as_tensor(
            notch_mask_unshifted(rdm.shape[-2], n_clutter), dtype=rdm.dtype, device=rdm.device
        )
    return rdm * keep[:, None]


def notch_mask_unshifted(n: int, n_clutter: int) -> np.ndarray:
    """(n,) float32 keep-mask of :func:`zero_velocity_notch_unshifted`."""
    idx = np.arange(n)
    return (~((idx <= n_clutter) | (idx >= n - n_clutter))).astype(np.float32)


def mti_cancel(echo: torch.Tensor, lag: int = 30) -> torch.Tensor:
    """``out[n] = x[n+lag] - x[n]`` for ``n < N-lag``; trailing ``lag`` rows zero."""
    n = echo.shape[-2]
    diff = echo[..., lag:, :] - echo[..., : n - lag, :]
    return torch.cat([diff, torch.zeros_like(echo[..., :lag, :])], dim=-2)


def stc_gain(stc_curve_db: np.ndarray, n: int) -> np.ndarray:
    """float32 iSTC gain ``10^(stc/20)`` over ``n`` fast-time samples
    (the curve zero-padded or truncated to ``n``, ``fun_iSTC.m:6-15``)."""
    stc = np.asarray(stc_curve_db, dtype=np.float32).reshape(-1)[:n]
    stc = np.concatenate([stc, np.zeros(n - stc.shape[0], np.float32)])
    return (np.float32(10.0) ** (stc / np.float32(20.0))).astype(np.float32)


def istc_compensate(echo: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Inverse-STC compensation: ``echo * gain`` along fast time."""
    return echo * gain

"""Spectral-width estimation (``CFAR_WangCai/ampConstrWidthEst.m``).

Port of ``radar_signal_process_tpu/ops/spectrum.py``: normalise the
magnitude spectrum to its peak in dB, optionally spline-upsample it, and
measure the width (in original-sample units) of the region at or above an
amplitude constraint (``ampConstrWidthEst.m:6-41``).

* :func:`amp_constrained_width` — the standalone utility on a complex
  spectrum, with the reference function's signature;
* :func:`detection_spectral_widths` — per-detection Doppler widths read off
  the magnitude RDM at each detection's range cell.
"""

from __future__ import annotations

import torch

from radar_signal_process_tpu_torch.ops.measure import spline_interp_notaknot


def _width_from_mag(
    mag: torch.Tensor, amp_constraint_db: float, interp: bool, interp_times: int
) -> torch.Tensor:
    """Index distance between the first and last samples ``>=
    amp_constraint_db`` (dB re the peak) along the last axis; 0 when none."""
    step = 1.0
    if interp:
        mag = spline_interp_notaknot(mag, interp_times)
        step = 1.0 / interp_times
    peak = mag.max(dim=-1, keepdim=True).values
    db = 20.0 * torch.log10(mag / peak)
    above = db >= amp_constraint_db
    n = above.shape[-1]
    idx = torch.arange(n, device=mag.device)
    first = torch.where(above, idx, n).min(dim=-1).values
    last = torch.where(above, idx, -1).max(dim=-1).values
    width = (last - first).to(db.dtype) * step
    return torch.where(above.any(dim=-1), width, 0.0)


def amp_constrained_width(
    spec: torch.Tensor,
    amp_constraint_db: float,
    interp: bool = False,
    interp_times: int = 4,
) -> torch.Tensor:
    """Width (in samples) of the region of the fftshift'ed magnitude of the
    complex spectrum ``spec`` (last axis) at or above ``amp_constraint_db``."""
    mag = torch.fft.fftshift(spec, dim=-1).abs()
    return _width_from_mag(mag, amp_constraint_db, interp, interp_times)


def detection_spectral_widths(
    rdm: torch.Tensor,
    r_idx: torch.Tensor,
    amp_constraint_db: float,
    shifted_input: bool = True,
    interp: bool = False,
    interp_times: int = 4,
) -> torch.Tensor:
    """Per-detection Doppler widths ``(..., K)`` from a magnitude RDM
    ``(..., n_v, n_r)``: the velocity column at each detection's range cell
    ``r_idx`` ``(..., K)`` is its Doppler spectrum.  ``shifted_input=False``
    fftshifts it first (G0 spectra are stored unshifted)."""
    n_v = rdm.shape[-2]
    idx = r_idx.long()[..., None, :].expand(*r_idx.shape[:-1], n_v, r_idx.shape[-1])
    cols = torch.gather(rdm, -1, idx).transpose(-1, -2)  # (..., K, n_v)
    if not shifted_input:
        cols = torch.fft.fftshift(cols, dim=-1)
    return _width_from_mag(cols, amp_constraint_db, interp, interp_times)

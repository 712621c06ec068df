"""Cell-averaging CFAR: 1-D CA-CFAR and the cascaded 2-D detector.

Port of ``radar_signal_process_tpu/ops/cfar.py`` (the roll form) and B1's
plain version.  Flags are bit-identical to the JAX op: the r-term running
sum is added in the same order, means divide by float(r), the threshold is
the f32 product ``level * T`` and ties go to the first maximum.

Replicated reference semantics (file:line):

* 1-D CA-CFAR: left/right reference-window means behind guard cells,
  fallback to the opposite side at the edges, greatest-of (method 0) /
  smallest-of (method 1), flag ``data >= T * ref`` —
  ``CFAR_WangCai/Function_CFAR1D_sub.m:17-68``;
* cascaded 2-D CFAR: crop the clutter rows, velocity-dim CFAR, then a dense
  range-dim pass whose strongest confirmed neighbour within +-E marks each
  velocity hit — ``CFAR_WangCai/executeCFAR.m:21-92``;
* per-pulse-segment CFAR over the concatenated RDM —
  ``CFAR_WangCai/main_cfar.m:142-161``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from radar_signal_process_tpu_torch.config import CFARConfig


def cfar1d_ref_level(
    data: torch.Tensor, ref_cells: int, guard_cells: int, method: int = 0, dim: int = -1
) -> torch.Tensor:
    """GO/SO reference level along ``dim`` (roll form, indices wrap).

    ``acc[y] = data[y] + data[y-1] + ... + data[y-(r-1)]`` added in that
    order; ``left = acc[y-(g+1)] / r`` and ``right = acc[y+(g+r)] / r``.
    The divisor is a tensor on ``data``'s device so that CUDA divides too:
    a CPU-scalar divisor would be turned into a reciprocal multiply there.
    """
    dim = dim % data.ndim
    n = data.shape[dim]
    r, g = ref_cells, guard_cells
    acc = data
    for k in range(1, r):
        acc = acc + torch.roll(data, k, dims=dim)
    r_t = torch.tensor(float(r), dtype=data.dtype, device=data.device)
    left_mean = torch.roll(acc, g + 1, dims=dim) / r_t
    right_mean = torch.roll(acc, -(g + r), dims=dim) / r_t

    shape = [1] * data.ndim
    shape[dim] = n
    idx = torch.arange(n, device=data.device).reshape(shape)
    left_used = torch.where(idx - (g + r) >= 0, left_mean, right_mean)
    right_used = torch.where(idx + (g + r) <= n - 1, right_mean, left_mean)
    if method == 0:
        return torch.maximum(left_used, right_used)
    return torch.minimum(left_used, right_used)


def cfar1d(
    data: torch.Tensor,
    ref_cells: int,
    guard_cells: int,
    threshold: float,
    method: int = 0,
    dim: int = -1,
) -> torch.Tensor:
    """1-D CA-CFAR flags (bool), ``Function_CFAR1D_sub`` semantics."""
    ref = cfar1d_ref_level(data, ref_cells, guard_cells, method, dim)
    return data >= ref * threshold


def _shift_range(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``out[..., r] = x[..., r+d]`` along the last axis, edge-filled."""
    if d == 0:
        return x
    pad = torch.full_like(x[..., : abs(d)], fill)
    if d > 0:
        return torch.cat([x[..., d:], pad], dim=-1)
    return torch.cat([pad, x[..., :d]], dim=-1)


def cascaded_cfar2d(
    rdm: torch.Tensor, cfg: CFARConfig, n_clutter: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascaded velocity-then-range 2-D CFAR (``executeCFAR.m``).

    ``rdm``: (..., n_velocity, n_range) float32 magnitude; ``n_clutter`` is
    the reference's ``MTD_0_num``.  Returns bool ``(flags, vflags)`` of the
    full shape.  Amplitudes must be finite.
    """
    nv = rdm.shape[-2]
    lo, hi = n_clutter + 1, nv - n_clutter
    used = rdm[..., lo:hi, :]

    vflag_used = cfar1d(
        used, cfg.ref_cells, cfg.guard_cells, cfg.threshold, cfg.method, dim=-2
    )
    vflags = torch.zeros(rdm.shape, dtype=torch.bool, device=rdm.device)
    vflags[..., lo:hi, :] = vflag_used
    if not cfg.range_detect:
        return vflags, vflags

    rflag = cfar1d(
        used, cfg.ref_cells, cfg.guard_cells, cfg.threshold, cfg.method, dim=-1
    )
    ext = cfg.range_extend_cells
    flags = torch.zeros(rdm.shape, dtype=torch.bool, device=rdm.device)
    if ext == 1:
        # flag-gated comparisons of the raw shifted amplitudes: candidate a
        # beats b when v_a >= v_b or b is unflagged; ">=" toward earlier
        # offsets keeps the first maximum
        f_m1, f_0, f_p1 = _shift_range(rflag, -1, False), rflag, _shift_range(rflag, 1, False)
        v_m1, v_0, v_p1 = _shift_range(used, -1, 0.0), used, _shift_range(used, 1, 0.0)
        winner = vflag_used & (f_m1 | f_0 | f_p1)
        take_m1 = f_m1 & ((v_m1 >= v_0) | ~f_0) & ((v_m1 >= v_p1) | ~f_p1)
        take_0 = ~take_m1 & f_0 & ((v_0 >= v_p1) | ~f_p1)
        take_p1 = ~take_m1 & ~take_0 & f_p1
        flags[..., lo:hi, :] = (
            _shift_range(winner & take_m1, 1, False)
            | (winner & take_0)
            | _shift_range(winner & take_p1, -1, False)
        )
        return flags, vflags

    # general neighbourhood: running best value / offset, strict ">" keeps
    # the first maximum
    neg_inf = torch.tensor(-torch.inf, dtype=used.dtype, device=used.device)
    best_val = torch.full_like(used, -torch.inf)
    best_off = torch.zeros(used.shape, dtype=torch.int32, device=used.device)
    for d in range(-ext, ext + 1):
        val = torch.where(
            _shift_range(rflag, d, False), _shift_range(used, d, 0.0), neg_inf
        )
        take = val > best_val
        best_val = torch.where(take, val, best_val)
        best_off = torch.where(take, torch.full_like(best_off, d), best_off)
    winner = vflag_used & (best_val > neg_inf)
    cascade = torch.zeros(used.shape, dtype=torch.bool, device=used.device)
    for d in range(-ext, ext + 1):
        # a winner at column r marks column r + d
        cascade = cascade | _shift_range(winner & (best_off == d), -d, False)
    flags[..., lo:hi, :] = cascade
    return flags, vflags


def segmented_cfar(
    rdm: torch.Tensor,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascaded CFAR per pulse segment (half-open column ranges), each
    segment on its own range axis, re-assembled along the columns."""
    parts = [cascaded_cfar2d(rdm[..., a:b], cfg, n_clutter) for a, b in segments]
    return (
        torch.cat([f for f, _ in parts], dim=-1),
        torch.cat([v for _, v in parts], dim=-1),
    )

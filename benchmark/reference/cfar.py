"""The cascaded 2-D CA-CFAR and the detection list, plainly.

A frozen copy of the roll form of the MATLAB reference
(``CFAR_WangCai/Function_CFAR1D_sub.m:17-68``, ``executeCFAR.m:21-92``,
``main_cfar.m:142-161``) in plain PyTorch, on any device: per pulse
segment, crop the clutter rows, a greatest-of / smallest-of velocity pass,
a range pass, and each velocity hit marks its strongest range-flagged
neighbour within +-E cells (first maximum on ties).  The r-term running
sum is added in the reference's order and the means divide by ``r`` (a
tensor, so CUDA divides and does not multiply by a reciprocal): the flags
are exact, not approximate, for the same float32 RDM.
"""

from __future__ import annotations

import numpy as np
import torch


def _ref_level(data: torch.Tensor, r: int, g: int, method: int, dim: int) -> torch.Tensor:
    dim = dim % data.ndim
    n = data.shape[dim]
    acc = data
    for k in range(1, r):
        acc = acc + torch.roll(data, k, dims=dim)
    r_t = torch.tensor(float(r), dtype=data.dtype, device=data.device)
    left = torch.roll(acc, g + 1, dims=dim) / r_t
    right = torch.roll(acc, -(g + r), dims=dim) / r_t
    shape = [1] * data.ndim
    shape[dim] = n
    idx = torch.arange(n, device=data.device).reshape(shape)
    left_used = torch.where(idx - (g + r) >= 0, left, right)
    right_used = torch.where(idx + (g + r) <= n - 1, right, left)
    return torch.maximum(left_used, right_used) if method == 0 else torch.minimum(left_used, right_used)


def _cfar1d(data: torch.Tensor, cfar: dict, dim: int) -> torch.Tensor:
    ref = _ref_level(data, cfar["ref_cells"], cfar["guard_cells"], cfar["method"], dim)
    return data >= ref * cfar["threshold"]


def _shift(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``out[..., y] = x[..., y + d]``, edge-filled with ``fill``."""
    if d == 0:
        return x
    n = x.shape[-1]
    k = min(abs(d), n)
    pad = torch.full_like(x[..., :k], fill)
    return torch.cat([x[..., k:], pad], -1) if d > 0 else torch.cat([pad, x[..., : n - k]], -1)


def _select(vflag, rflag, used, ext: int) -> torch.Tensor:
    best_val = torch.full_like(used, -torch.inf)
    best_off = torch.zeros(used.shape, dtype=torch.int32, device=used.device)
    for d in range(-ext, ext + 1):
        val = torch.where(_shift(rflag, d, False), _shift(used, d, 0.0), -torch.inf)
        take = val > best_val
        best_val = torch.where(take, val, best_val)
        best_off = best_off.masked_fill(take, d)
    winner = vflag & (best_val > -torch.inf)
    out = torch.zeros(used.shape, dtype=torch.bool, device=used.device)
    for d in range(-ext, ext + 1):
        out = out | _shift(winner & (best_off == d), -d, False)
    return out


def cascade(rdm: torch.Tensor, cfar: dict, n_clutter: int, segments, zero_rows=None):
    """float32 RDM (..., n_v, n_r) -> bool ``(flags, vflags)``.  ``zero_rows``
    (a half-open row range) is read as 0.0: the CFAR stage's re-notch."""
    nv, nr = rdm.shape[-2], rdm.shape[-1]
    if zero_rows is not None:
        keep = torch.ones(nv, dtype=rdm.dtype, device=rdm.device)
        keep[zero_rows[0]:zero_rows[1]] = 0.0
        rdm = rdm * keep[:, None]
    lo, hi = n_clutter + 1, nv - n_clutter
    flags = torch.zeros(rdm.shape, dtype=torch.bool, device=rdm.device)
    vflags = torch.zeros_like(flags)
    for a, b in segments or [(0, nr)]:
        used = rdm[..., lo:hi, a:b]
        vf = _cfar1d(used, cfar, -2)
        vflags[..., lo:hi, a:b] = vf
        if cfar["range_detect"]:
            rf = _cfar1d(used, cfar, -1)
            flags[..., lo:hi, a:b] = _select(vf, rf, used, cfar["range_extend_cells"])
        else:
            flags[..., lo:hi, a:b] = vf
    return flags, vflags


def renotch_zero_rows(n_v: int, divisor: int, n_clutter: int, shifted: bool):
    """The rows of the CFAR-stage re-notch (``N/divisor`` around zero
    velocity of a shifted spectrum) inside the crop, half-open, or None."""
    if not divisor or not shifted:
        return None
    half = int(np.floor(n_v / divisor + 0.5))
    center = int(np.floor(n_v / 2 + 0.5)) - 1
    a, b = max(center - half, n_clutter + 1), min(center + half + 1, n_v - n_clutter)
    return (a, b) if a < b else None


def detection_list(flags: torch.Tensor, rdm: torch.Tensor, k: int):
    """The ``k`` strongest flagged cells of each RDM of the leading axes, on
    the host: ``(amplitudes (.., k) descending, cells (.., k, 2) as (v, r))``;
    entries with no flagged cell read -1.  A stable sort, not a top-k."""
    nv, nr = rdm.shape[-2:]
    lead = tuple(rdm.shape[:-2])
    scores = torch.where(flags, rdm, -1.0).reshape(-1, nv * nr)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    k = min(k, nv * nr)
    vals, idx = vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
    cells = np.stack([idx // nr, idx % nr], -1)
    return vals.reshape(lead + (k,)), cells.reshape(lead + (k, 2))


def detection_mismatches(amp, v_idx, r_idx, ref_amp, ref_cells) -> int:
    """Entries of a program's detection lists that the reference's lists do
    not hold: amplitudes compared exactly in order, cells compared as sets
    among the valid entries stronger than the list's last one (equal
    amplitudes at the cut may be kept in any order)."""
    k = ref_amp.shape[-1]
    ref_amp, ref_cells = ref_amp.reshape(-1, k), ref_cells.reshape(-1, k, 2)
    amp = np.asarray(amp, np.float32).reshape(ref_amp.shape)
    cells = np.stack([np.asarray(v_idx), np.asarray(r_idx)], -1).reshape(ref_cells.shape)
    bad = int((amp != ref_amp).sum())
    strong = (ref_amp > ref_amp[:, -1:]) & (ref_amp > 0)
    same = (cells == ref_cells).all(-1) | ~strong
    for i in np.flatnonzero(~same.all(-1)):       # lists whose cells differ in order
        a, c, ra, rc, s = amp[i], cells[i], ref_amp[i], ref_cells[i], strong[i]
        mine = {tuple(x) for x in c[(a > ra[-1]) & (a > 0)]}
        bad += len(mine ^ {tuple(x) for x in rc[s]})
    return bad

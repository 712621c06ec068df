"""Cell-averaging CFAR: 1-D CA-CFAR and the cascaded 2-D detector.

Port of ``radar_signal_process_tpu/ops/cfar.py``: the roll form (B1's
plain version) and the split padded forms (``segmented_cfar_flags`` /
``_select``, and the threshold sweep's ``segmented_cfar_ref_levels`` /
``_from_ref_levels``).  Flags are bit-identical to the JAX op: the r-term running
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


def _shift_range(x: torch.Tensor, d: int, fill, dim: int = -1) -> torch.Tensor:
    """``out[..., y] = x[..., y+d]`` along ``dim``, edge-filled with ``fill``."""
    if d == 0:
        return x
    n = x.shape[dim]
    k = min(abs(d), n)          # a shift past the axis leaves only fill
    pad = torch.full_like(x.narrow(dim, 0, k), fill)
    if d > 0:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, n - k)], dim=dim)


def _select(
    vflag: torch.Tensor, rflag: torch.Tensor, used: torch.Tensor, ext: int, dim: int
) -> torch.Tensor:
    """The cascade: each velocity hit marks its strongest range-flagged
    neighbour within +-``ext`` cells along ``dim`` (first maximum on ties)."""
    if ext == 1:
        # flag-gated comparisons of the raw shifted amplitudes: candidate a
        # beats b when v_a >= v_b or b is unflagged; ">=" toward earlier
        # offsets keeps the first maximum
        f_m1, f_0, f_p1 = _shift_range(rflag, -1, False, dim), rflag, _shift_range(rflag, 1, False, dim)
        v_m1, v_0, v_p1 = _shift_range(used, -1, 0.0, dim), used, _shift_range(used, 1, 0.0, dim)
        winner = vflag & (f_m1 | f_0 | f_p1)
        take_m1 = f_m1 & ((v_m1 >= v_0) | ~f_0) & ((v_m1 >= v_p1) | ~f_p1)
        take_0 = ~take_m1 & f_0 & ((v_0 >= v_p1) | ~f_p1)
        take_p1 = ~take_m1 & ~take_0 & f_p1
        return (
            _shift_range(winner & take_m1, 1, False, dim)
            | (winner & take_0)
            | _shift_range(winner & take_p1, -1, False, dim)
        )
    # general neighbourhood: running best value / offset, strict ">" keeps
    # the first maximum
    best_val = torch.full_like(used, -torch.inf)
    best_off = torch.zeros(used.shape, dtype=torch.int32, device=used.device)
    for d in range(-ext, ext + 1):
        val = torch.where(
            _shift_range(rflag, d, False, dim), _shift_range(used, d, 0.0, dim), -torch.inf
        )
        take = val > best_val
        best_val = torch.where(take, val, best_val)
        best_off = best_off.masked_fill(take, d)
    winner = vflag & (best_val > -torch.inf)
    cascade = torch.zeros(used.shape, dtype=torch.bool, device=used.device)
    for d in range(-ext, ext + 1):
        # a winner at column r marks column r + d
        cascade = cascade | _shift_range(winner & (best_off == d), -d, False, dim)
    return cascade


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
    flags = torch.zeros(rdm.shape, dtype=torch.bool, device=rdm.device)
    flags[..., lo:hi, :] = _select(vflag_used, rflag, used, cfg.range_extend_cells, -1)
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


# ---------------------------------------------------------------------------
# Split forms: stage A (flag planes), stage B (cascade), and the threshold
# sweep's reference levels.  Shifted windows are slices of one zero-padded
# buffer.  The r-term sums are added in the roll form's order, so above the
# parity floor (ROADMAP C3: a cropped extent of 2(r+g)+1 cells) the flags
# are bit-identical to the roll form; below it the out-of-range windows read
# zeros here and wrapped values there.  ``transposed=True`` takes and
# returns the (..., n_range, n_velocity) layout
# (``ops.mtd.doppler_process_range_major``).
# ---------------------------------------------------------------------------


def _pad(x: torch.Tensor, before: int, after: int, dim: int) -> torch.Tensor:
    """``x`` with ``before``/``after`` zeros (False) along ``dim``."""
    shape = list(x.shape)
    parts = []
    for n in (before, after):
        shape[dim] = n
        parts.append(torch.zeros(shape, dtype=x.dtype, device=x.device))
    return torch.cat([parts[0], x, parts[1]], dim=dim)


def _ref_level_padded(
    data: torch.Tensor, ref_cells: int, guard_cells: int, method: int, dim: int
) -> torch.Tensor:
    """:func:`cfar1d_ref_level` as slices of one zero-padded buffer."""
    dim = dim % data.ndim
    n = data.shape[dim]
    r, g = ref_cells, guard_cells
    padded = _pad(data, g + r, g + r, dim)

    def shifted(off: int) -> torch.Tensor:  # out[y] = data[y + off]
        return padded.narrow(dim, g + r + off, n)

    left = shifted(-(g + 1))
    for j in range(1, r):
        left = left + shifted(-(g + 1) - j)
    right = shifted(g + r)
    for j in range(1, r):
        right = right + shifted(g + r - j)
    r_t = torch.tensor(float(r), dtype=data.dtype, device=data.device)
    left_mean, right_mean = left / r_t, right / r_t

    shape = [1] * data.ndim
    shape[dim] = n
    idx = torch.arange(n, device=data.device).reshape(shape)
    left_used = torch.where(idx - (g + r) >= 0, left_mean, right_mean)
    right_used = torch.where(idx + (g + r) <= n - 1, right_mean, left_mean)
    if method == 0:
        return torch.maximum(left_used, right_used)
    return torch.minimum(left_used, right_used)


def _axes(transposed: bool) -> Tuple[int, int]:
    """(velocity dim, range dim) of the split forms' layout."""
    return (-1, -2) if transposed else (-2, -1)


def _used(rdm: torch.Tensor, n_clutter: int, v_dim: int) -> torch.Tensor:
    """The rows (velocity cells) the CFAR decides: ``n_clutter+1 .. n_v-n_clutter``."""
    return rdm.narrow(v_dim, n_clutter + 1, rdm.shape[v_dim] - 2 * n_clutter - 1)


def segmented_cfar_flags(
    rdm: torch.Tensor,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    cfg_range: CFARConfig | None = None,
    transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage A of the split cascade: the ``(vflag, rflag)`` planes over the
    cropped rows and all columns.  The velocity pass is column-local, so one
    full-width pass equals the per-segment form; the range pass keeps to
    segment edges."""
    cfg_r = cfg_range or cfg
    v_dim, r_dim = _axes(transposed)
    used = _used(rdm, n_clutter, v_dim)
    vref = _ref_level_padded(used, cfg.ref_cells, cfg.guard_cells, cfg.method, v_dim)
    vflag = used >= vref * cfg.threshold
    if not cfg.range_detect:
        return vflag, vflag
    rflags = []
    for start, stop in segments:
        seg = used.narrow(r_dim, start, stop - start)
        rref = _ref_level_padded(seg, cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.method, r_dim)
        rflags.append(seg >= rref * cfg_r.threshold)
    return vflag, torch.cat(rflags, dim=r_dim)


def segmented_cfar_ref_levels(
    rdm: torch.Tensor,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    cfg_range: CFARConfig | None = None,
    transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threshold-independent reference levels ``(vref, rref)``: a sweep
    forms them once per RDM and re-runs only the compare and the cascade
    per threshold (:func:`segmented_cfar_from_ref_levels`)."""
    cfg_r = cfg_range or cfg
    v_dim, r_dim = _axes(transposed)
    used = _used(rdm, n_clutter, v_dim)
    vref = _ref_level_padded(used, cfg.ref_cells, cfg.guard_cells, cfg.method, v_dim)
    rrefs = [
        _ref_level_padded(used.narrow(r_dim, start, stop - start), cfg_r.ref_cells,
                          cfg_r.guard_cells, cfg_r.method, r_dim)
        for start, stop in segments
    ]
    return vref, torch.cat(rrefs, dim=r_dim)


def segmented_cfar_from_ref_levels(
    rdm: torch.Tensor,
    vref: torch.Tensor,
    rref: torch.Tensor,
    threshold: torch.Tensor | float,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    threshold_range: torch.Tensor | float | None = None,
    transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cascade flags from precomputed reference levels at ``threshold``:
    bit-identical to :func:`segmented_cfar` with ``cfg.threshold ==
    threshold`` on the same RDM (above the parity floor)."""
    t_r = threshold if threshold_range is None else threshold_range
    v_dim, _ = _axes(transposed)
    used = _used(rdm, n_clutter, v_dim)
    vflag = used >= vref * threshold
    rflag = used >= rref * t_r if cfg.range_detect else vflag
    return segmented_cfar_select(rdm, vflag, rflag, segments, cfg, n_clutter, transposed)


def segmented_cfar_select(
    rdm: torch.Tensor,
    vflag: torch.Tensor,
    rflag: torch.Tensor,
    segments: Sequence[Tuple[int, int]],
    cfg: CFARConfig,
    n_clutter: int,
    transposed: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage B of the split cascade: the strongest-neighbour resolution per
    segment, then the full-size ``(flags, vflags)`` pair (clutter rows
    False), bit-identical to :func:`segmented_cfar`."""
    v_dim, r_dim = _axes(transposed)
    lo, hi = n_clutter + 1, rdm.shape[v_dim] - n_clutter
    nv = rdm.shape[v_dim]
    vflags = _pad(vflag, lo, nv - hi, v_dim)
    if not cfg.range_detect:
        return vflags, vflags
    used = _used(rdm, n_clutter, v_dim)
    parts = [
        _select(*(x.narrow(r_dim, start, stop - start) for x in (vflag, rflag, used)),
                cfg.range_extend_cells, r_dim)
        for start, stop in segments
    ]
    return _pad(torch.cat(parts, dim=r_dim), lo, nv - hi, v_dim), vflags

"""B1: fused cascaded 2-D CA-CFAR.

Replaces ``radar_signal_process_tpu/kernels/cfar_pallas.py::
cascaded_cfar2d_pallas``.  Flags are bit-identical to
``ops.cfar.segmented_cfar`` (the fifth implementation kept in lockstep:
same summation order, division by float(r), f32 threshold product, edge
fallback, strict ``>`` first-maximum cascade).

On a CUDA tensor :func:`cascaded_cfar2d` launches ``csrc/cfar.cu`` once per
call, over every pulse segment.  The kernel is bound by bytes (read the used
f32 rows, write two byte-wide flag maps, ~0.31 GB per G2 window): a block
streams a strip of columns down a band of rows, four columns a thread, its
rows brought into shared memory by TMA (or by cp.async where the row stride
is not a multiple of 16 bytes), forms each window mean once, and stores each
row's flags as it goes.  An RDM no wider than ``NARROW_TX`` columns (G0's
62-column short segment) takes the kernel's narrow body instead, a thread a
column.  ``zero_rows`` fuses the CFAR stage's re-notch into the load: those
rows read as 0.0 and are not fetched.  :func:`cfar_plan` (plain Python, so
the CPU tests reach it) picks the body, cuts the RDM into strips and bands
and prices them with :func:`plan_cost`.  On a CPU tensor the wrapper runs
the plain ``ops.cfar`` version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from radar_signal_process_tpu_torch.config import CFARConfig
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar

SMEM_LIMIT = _build.SMEM_LIMIT
MAX_SEGMENTS = 32        # the kernel's segment table (csrc/cfar.cu kMaxSegments)
PREFETCH, ROWS = 4, 4    # rows staged ahead, rows a step (csrc/cfar.cu kPrefetch, kRows)
H100_SMS = 132
STRIPS = (128, 256, 512, 1024)  # staged tile widths csrc/cfar.cu is built for
COLS = 4                 # neighbouring columns a thread (csrc/cfar.cu kCols)
# the narrow body's output columns a strip and rows in flight (csrc/cfar.cu
# kNarrowTx, kNarrowPrefetch)
NARROW_TX, NARROW_PREFETCH = 64, 8
# The band model of cfar_plan (plan_cost): a block's row steps of ROWS rows
# take one time each, the steps that only fill the velocity pipeline
# FILL_SHARE of it, whatever the warps resident on the SM (up to the ten a
# G2 launch keeps there); the blocks run in whole waves of the SMs'
# resident slots.  Set so the model picks, at G2, the sweep's batch, the
# mesh's halo-extended blocks and G0's 512 columns, the fastest of the
# variants tools/bench_b1.py --plans times there on an NVIDIA H100 80GB
# HBM3 at 700 W: tiles of 256 and bands of 101 at G2 and on the mesh blocks
# (two whole waves at sp = 2, one at sp = 4), bands of 31 for the sweep's
# batch (one wave), tiles of 128 and bands of 12 at G0 (tiles of 256 tie
# there, 2% faster).
FILL_SHARE = 0.7


class CfarPlan(NamedTuple):
    """Block map of one launch.  The tile body: each strip of ``tx`` output
    columns stages ``sw = tx + 2 * halo`` columns a row, ``COLS`` a thread
    (``threads``); a block walks a band of ``band_rows`` cropped rows of one
    RDM down one strip, ``blockIdx.x = strip * n_bands + band`` and
    ``grid.y`` the batch.  The narrow body (``narrow``): strips of up to
    ``tx = NARROW_TX`` columns are cut from each segment, their halo
    (``2e + r + g`` columns a side) wrapped inside it, a thread a staged
    column, and a segment's blocks follow the last segment's.  ``table``
    holds one ``(col0, ns)`` per segment.  ``tma`` says how rows are staged:
    by TMA, or by cp.async where the row stride is not a multiple of 16
    bytes (and always in the narrow body)."""

    sw: int
    tx: int
    halo: int
    band_rows: int
    threads: int
    table: Tuple[Tuple[int, int], ...]
    n_strips: int
    n_bands: int
    n_blocks: int
    smem: int
    tma: bool
    narrow: bool


def halo_columns(cfg: CFARConfig) -> int:
    """Range halo a side, ``2e + r + g`` rounded up to whole 16-byte groups."""
    return -(-(2 * cfg.range_extend_cells + cfg.ref_cells + cfg.guard_cells) // 4) * 4


def smem_bytes(sw: int, r: int, g: int) -> int:
    """Shared-memory bytes of one block (``csrc/cfar.cu`` layout: the ring of
    staged rows in whole steps of ``ROWS``, the ring of velocity means, two
    buffers of cascade marks, an mbarrier a step of rows)."""
    data = -(-(PREFETCH + ROWS + g + r) // ROWS) * ROWS
    means = 2 * g + r + 1 + (0 if 2 * g + r + 1 >= ROWS else ROWS)
    return 4 * (data + means) * sw + 2 * ROWS * sw + 8 * (data // ROWS)


def narrow_threads(r: int, g: int, e: int) -> int:
    """Threads of a narrow block: a staged column each, in whole warps."""
    return -(-(NARROW_TX + 2 * (2 * e + r + g)) // 32) * 32


def narrow_smem_bytes(r: int, g: int, e: int) -> int:
    """Shared-memory bytes of a narrow block (``csrc/cfar.cu``: the ring of
    staged rows, the ring of velocity means, a step's cascade marks)."""
    return (4 * ((NARROW_PREFETCH + ROWS + g + r) * (NARROW_TX + 2 * (2 * e + r + g))
                 + (2 * g + r + 1 + ROWS) * (NARROW_TX + 2 * e)) + ROWS * NARROW_TX)


def plan_for(
    segments: Sequence[Tuple[int, int]], nvu: int, cfg: CFARConfig, sw: int, band_rows: int,
    tma: bool = True,
) -> CfarPlan:
    """The block map of tiles ``sw`` columns wide (0: the narrow body) and
    bands of ``band_rows`` rows; ``tma`` where the layout allows it."""
    nr = segments[-1][1]
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    table = tuple((a, b - a) for a, b in segments)
    n_bands = -(-nvu // band_rows)
    if sw == 0:
        halo = 2 * e + r + g
        n_strips = sum(-(-ns // NARROW_TX) for _, ns in table)
        return CfarPlan(NARROW_TX + 2 * halo, NARROW_TX, halo, band_rows, narrow_threads(r, g, e),
                        table, n_strips, n_bands, n_strips * n_bands, narrow_smem_bytes(r, g, e),
                        False, True)
    halo = halo_columns(cfg)
    n_strips = -(-nr // (sw - 2 * halo))
    return CfarPlan(sw, sw - 2 * halo, halo, band_rows, sw // COLS, table, n_strips, n_bands,
                    n_strips * n_bands, smem_bytes(sw, r, g), tma, False)


def cfar_plan(
    segments: Sequence[Tuple[int, int]], nvu: int, batch: int, cfg: CFARConfig,
    n_sms: int = H100_SMS, aligned: bool = True,
) -> CfarPlan:
    """The block map for ``segments`` (tiling ``[0, nr)``) over ``nvu``
    cropped rows, from the shape alone.

    An RDM no wider than ``NARROW_TX`` columns takes the narrow body (G0's
    62-column short segment); any other the tile body, its rows staged by
    TMA when the row stride is a multiple of 16 bytes (``nr % 4 == 0``) and
    ``aligned`` (the RDM starts on a 16-byte boundary), else by cp.async.
    The tile width and the band length minimise :func:`plan_cost`.
    """
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments outside 1..{MAX_SEGMENTS}")
    nr = segments[-1][1]
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    halo = halo_columns(cfg)
    tma = aligned and nr % 4 == 0
    if (nr <= NARROW_TX and narrow_threads(r, g, e) <= 1024
            and narrow_smem_bytes(r, g, e) <= SMEM_LIMIT):
        tiles = (0,)
    else:
        tiles = tuple(sw for sw in STRIPS if sw - 2 * halo >= 4 and sw // COLS <= 1024
                      and smem_bytes(sw, r, g) <= SMEM_LIMIT)
    if not tiles:
        raise ValueError(
            f"CFAR windows {cfg} need a halo of {halo} columns a side: no tile of "
            f"{STRIPS[-1]} columns ({STRIPS[-1] // COLS} threads) fits {SMEM_LIMIT} B of "
            f"shared memory with room for output columns"
        )
    bands = sorted({-(-nvu // n) for n in range(1, nvu + 1)}, reverse=True)
    plans = (plan_for(segments, nvu, cfg, sw, band_rows, tma)
             for sw in tiles for band_rows in bands)
    return min(plans, key=lambda plan: plan_cost(plan, batch, cfg, n_sms))


def plan_cost(plan: CfarPlan, batch: int, cfg: CFARConfig, n_sms: int = H100_SMS) -> float:
    """The band model's time of one launch, in row steps of one block.

    A block walks ``ceil((band_rows + 2(g+r)) / ROWS)`` steps, the first
    ``2(g+r) // ROWS`` of them only filling the velocity pipeline
    (FILL_SHARE of a step each), and the blocks run in whole waves of the
    SMs' resident slots: a wave that is not full takes as long as a full
    one.
    """
    lag = cfg.guard_cells + cfg.ref_cells
    per_sm = max(1, min(2048 // plan.threads, 32, 233472 // (plan.smem + 1024)))
    waves = -(-batch * plan.n_blocks // (n_sms * per_sm))
    steps = -(-(plan.band_rows + 2 * lag) // ROWS) - (1 - FILL_SHARE) * (2 * lag // ROWS)
    return waves * steps


def plan_tile(plan: CfarPlan, block: int) -> Tuple[int, int, int, int]:
    """``(x_begin, x_end, y_begin, y_end)`` of ``blockIdx.x == block``,
    decoded as the kernel decodes it: the block decides cropped rows
    ``[y_begin, y_end)`` of RDM columns ``[x_begin, x_end)``."""
    nr = plan.table[-1][0] + plan.table[-1][1]
    x_lo, x_hi = 0, nr
    if plan.narrow:
        for x_lo, ns in plan.table:
            x_hi = x_lo + ns
            if block < -(-ns // plan.tx) * plan.n_bands:
                break
            block -= -(-ns // plan.tx) * plan.n_bands
    strip, band = divmod(block, plan.n_bands)
    x0 = x_lo + strip * plan.tx
    return x0, min(x0 + plan.tx, x_hi), band * plan.band_rows, (band + 1) * plan.band_rows


def plan_key(
    segments: Sequence[Tuple[int, int]], nvu: int, batch: int, cfg: CFARConfig, n_sms: int,
    aligned: bool = True,
) -> tuple:
    """What shapes a launch's plan: the geometry, the windows, the method,
    the card's SMs and whether the RDM starts on a 16-byte boundary.  The
    threshold is not in it: a threshold sweep reuses one plan (the kernel
    takes the threshold at run time), nor are the re-notched rows."""
    return (tuple(segments), nvu, batch, cfg.ref_cells, cfg.guard_cells,
            cfg.range_extend_cells, cfg.method, n_sms, aligned)


def extended_segments(
    n_global: int, segments: Sequence[Tuple[int, int]], col0: int, local_n: int, halo: int,
) -> Tuple[Tuple[int, int], ...]:
    """Segment table of a range shard's halo-extended block.

    The block holds global columns ``[col0 - halo, col0 + local_n + halo)``.
    Each real segment (``segments`` tile ``[0, n_global)``) is clipped to
    that range; each run of wrapped columns (global index < 0 or >=
    ``n_global``) gets one dummy segment of its own.  The table is in block
    columns and tiles ``[0, local_n + 2 * halo)``.  Run over the block,
    B1 decides each segment alone, so the dummy segments never reach a real
    column, and a clip at the block's edge changes only columns within
    ref + guard of it: with ``halo = ref + guard + 2E`` the centre columns,
    their cascade candidates and those candidates' windows stay clear of it.
    """
    edges = [0] + [b for _, b in segments]
    if [a for a, _ in segments] != edges[:-1] or edges[-1] != n_global:
        raise ValueError(f"segments {segments} do not tile [0, {n_global})")
    if not 0 <= halo <= local_n or not 0 <= col0 <= n_global - local_n:
        raise ValueError(
            f"block at column {col0} of {local_n} (+{halo} halo) outside [0, {n_global})"
        )
    lo, hi = col0 - halo, col0 + local_n + halo
    table = [(lo, 0)] if lo < 0 else []
    table += [(max(a, lo), min(b, hi)) for a, b in segments if max(a, lo) < min(b, hi)]
    if hi > n_global:
        table.append((n_global, hi))
    return tuple((a - lo, b - lo) for a, b in table)


@functools.lru_cache(maxsize=64)
def _launch_table(segments, nvu: int, batch: int, r: int, g: int, e: int, method: int,
                  n_sms: int, aligned: bool):
    """The plan of one launch and its segment table as the C entry point
    takes it (col0[], end[]), built once per :func:`plan_key`."""
    plan = cfar_plan(segments, nvu, batch,
                     CFARConfig(ref_cells=r, guard_cells=g, range_extend_cells=e,
                                method=method), n_sms, aligned)
    if _build.library().rsp_cascaded_cfar_smem_bytes(0 if plan.narrow else plan.sw, r, g,
                                                      e) != plan.smem:
        raise RuntimeError("cascaded_cfar2d: csrc/cfar.cu and smem_bytes disagree")
    table = (ctypes.c_int * (2 * len(plan.table)))(
        *(c for c, _ in plan.table), *(c + w for c, w in plan.table))
    return plan, table


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _zero_rows(zero_rows: Optional[Tuple[int, int]], nv: int) -> Tuple[int, int]:
    """``zero_rows`` clipped to ``[0, nv)``, ``(0, 0)`` when empty."""
    if zero_rows is None:
        return 0, 0
    a, b = max(int(zero_rows[0]), 0), min(int(zero_rows[1]), nv)
    return (a, b) if a < b else (0, 0)


def cascaded_cfar2d_plain(
    rdm: torch.Tensor,
    cfg: CFARConfig,
    n_clutter: int,
    segments: Sequence[Tuple[int, int]] | None = None,
    zero_rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's plain version, on any device: ``rdm * keep[:, None]`` with
    ``keep`` zero on ``zero_rows`` (the CFAR stage's re-notch), then
    ``ops.cfar.segmented_cfar``.  The mask is filled on ``rdm``'s device,
    so nothing is copied from the host."""
    nv = rdm.shape[-2]
    za, zb = _zero_rows(zero_rows, nv)
    if za < zb:
        keep = torch.ones(nv, dtype=rdm.dtype, device=rdm.device)
        keep[za:zb] = 0.0
        rdm = rdm * keep[:, None]
    return segmented_cfar(rdm, segments or ((0, rdm.shape[-1]),), cfg, n_clutter)


def cascaded_cfar2d(
    rdm: torch.Tensor,
    cfg: CFARConfig,
    n_clutter: int,
    segments: Sequence[Tuple[int, int]] | None = None,
    zero_rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDM (..., n_velocity, n_range) float32 -> bool ``(flags, vflags)``.

    ``segments`` (half-open column ranges tiling ``[0, n_range)`` once
    clipped to it, default one segment) each get their own range axis, as
    in ``segmented_cfar``.  ``zero_rows`` (a half-open Doppler row range,
    None or empty for none) reads as 0.0: the result is the plain version's
    on ``rdm * keep[:, None]`` with ``keep`` zero there, for any finite RDM.
    CPU tensor: the plain version, :func:`cascaded_cfar2d_plain`.
    CUDA tensor: one kernel launch, or an exception;
    ``cascaded_cfar2d.launches`` counts the kernel launches.
    """
    nv, nr = rdm.shape[-2], rdm.shape[-1]
    # clip to the RDM width as slicing does, dropping empty segments
    segments = tuple(
        (a, min(b, nr)) for a, b in (segments or ((0, nr),)) if a < min(b, nr)
    )
    if rdm.device.type == "cpu":
        return cascaded_cfar2d_plain(rdm, cfg, n_clutter, segments, zero_rows)
    if rdm.device.type != "cuda":
        raise ValueError(f"cascaded_cfar2d: unsupported device {rdm.device}")
    if rdm.dtype != torch.float32 or not rdm.is_contiguous():
        raise ValueError(
            f"cascaded_cfar2d: rdm must be contiguous float32, got {rdm.dtype}"
        )
    lo, nvu = n_clutter + 1, nv - 2 * n_clutter - 1
    if n_clutter < 0 or nvu < 1:
        raise ValueError(f"n_clutter {n_clutter} leaves no rows of {nv}")
    if not 0 <= cfg.range_extend_cells <= 127:
        raise ValueError(
            f"range_extend_cells {cfg.range_extend_cells} outside 0..127"
        )
    if cfg.ref_cells < 1 or cfg.guard_cells < 0:
        raise ValueError(f"bad CFAR windows: {cfg}")
    edges = [0] + [b for _, b in segments]
    if [a for a, _ in segments] != edges[:-1] or edges[-1] != nr:
        raise ValueError(f"segments {segments} do not tile [0, {nr})")
    batch = rdm.numel() // (nv * nr) if nv * nr else 0
    if not 0 < batch <= 65535:
        raise ValueError(f"cascaded_cfar2d: batch {batch} outside 1..65535")

    za, zb = _zero_rows(zero_rows, nv)
    ptr = rdm.data_ptr()
    plan, table = _launch_table(*plan_key(segments, nvu, batch, cfg,
                                          _sm_count(rdm.device.index), ptr % 16 == 0))
    out = torch.empty((2,) + tuple(rdm.shape), dtype=torch.bool, device=rdm.device)
    stream = torch.cuda.current_stream(rdm.device).cuda_stream
    rc = _build.library().rsp_cascaded_cfar(
        ptr, out.data_ptr(), out.data_ptr() + rdm.numel(), batch, nv, nr, lo, nvu,
        len(plan.table), table, 0 if plan.narrow else plan.sw, plan.band_rows,
        cfg.ref_cells, cfg.guard_cells, cfg.method, float(cfg.threshold),
        cfg.range_extend_cells, int(cfg.range_detect),
        za, zb, int(plan.tma), stream,
    )
    _build.check(rc, "rsp_cascaded_cfar")
    cascaded_cfar2d.launches += 1
    return out[0], out[1]


cascaded_cfar2d.launches = 0


def division_mismatches(device: torch.device | str = "cuda") -> int:
    """The float32 bit patterns, of all 2^32, where B1's division by 5
    (``csrc/cfar.cu::div5``, an FMA sequence) differs in any bit from IEEE
    division ``__fdiv_rn(x, 5.0f)``: 0, or B1 is not bit-identical to its
    plain version.  On the card only (a few ms); not a B1 launch."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"division_mismatches: runs on the card, not {device}")
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _build.check(_build.library().rsp_check_div5(bad.data_ptr(), stream), "rsp_check_div5")
    return int(bad.item())

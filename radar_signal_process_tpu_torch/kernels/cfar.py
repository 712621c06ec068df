"""B1: fused cascaded 2-D CA-CFAR.

Replaces ``radar_signal_process_tpu/kernels/cfar_pallas.py::
cascaded_cfar2d_pallas``.  Flags are bit-identical to
``ops.cfar.segmented_cfar`` (the fifth implementation kept in lockstep:
same summation order, division by float(r), f32 threshold product, edge
fallback, strict ``>`` first-maximum cascade).

On a CUDA tensor :func:`cascaded_cfar2d` launches ``csrc/cfar.cu`` once per
call, over every pulse segment.  The kernel is bound by bytes (read the used
f32 rows, write two byte-wide flag maps, ~0.33 GB per G2 window): a block
streams a strip of columns down a band of rows, one thread a column, forms
each window mean once, and stores each row's flags as it goes.
:func:`cfar_plan` (plain Python, so the CPU tests reach it) cuts the
segments into strips and bands.  On a CPU tensor the wrapper runs the plain ``ops.cfar`` version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import CFARConfig
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper
MAX_SEGMENTS = 32        # the kernel's segment table (csrc/cfar.cu kMaxSegments)
PREFETCH, ROWS = 8, 4    # rows in flight, rows per step (csrc/cfar.cu kPrefetch, kRows)
H100_SMS = 132
STRIPS = (256, 128, 64)  # strip widths csrc/cfar.cu is built for, the widest first
# the band model of cfar_plan, fitted to H100 runs of csrc/cfar.cu at the G2
# and G0 shapes: a row step of a block takes STEP_LATENCY cycles plus
# STEP_ISSUE for each warp resident on its SM; a step that only fills the
# pipeline costs FILL_SHARE of one that decides cells
STEP_LATENCY, STEP_ISSUE, FILL_SHARE = 100, 32, 0.3


class CfarPlan(NamedTuple):
    """Block map of one launch.  A block walks a band of ``band_rows``
    cropped rows down a strip of ``tx`` columns with ``threads`` threads, one
    a staged column; ``table`` holds one ``(col0, ns, first_block)`` per
    segment, blocks of a segment run strip by strip, band fastest, and
    ``grid.y`` is the batch."""

    tx: int
    band_rows: int
    threads: int
    table: Tuple[Tuple[int, int, int], ...]
    n_bands: int
    n_blocks: int
    smem: int


def smem_bytes(tx: int, r: int, g: int, e: int) -> int:
    """Shared-memory bytes of one block (``csrc/cfar.cu`` layout: the ring of
    staged rows, the ring of velocity means, the row's cascade flags)."""
    sw = tx + 2 * (2 * e + r + g)
    return (4 * ((PREFETCH + ROWS + g + r) * sw + (2 * g + r + 1 + ROWS) * (tx + 2 * e))
            + ROWS * tx)


def cfar_plan(
    segments: Sequence[Tuple[int, int]], nvu: int, batch: int, cfg: CFARConfig,
    n_sms: int = H100_SMS,
) -> CfarPlan:
    """The block map for ``segments`` over ``nvu`` cropped rows.

    Strips are the widest of ``STRIPS`` that some segment fills more than
    half of and that fits a block.  Each band restarts the velocity
    pipeline, which costs 2(g+r) row steps; the band length minimises the
    modelled time: the row steps of all blocks over the SMs' resident blocks,
    at cycles a step that grow with the warps resident, plus the last
    block's steps alone.
    """
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{len(segments)} segments outside 1..{MAX_SEGMENTS}")
    widest = max(b - a for a, b in segments)
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    for tx in [w for w in STRIPS if 2 * widest > w] or STRIPS[-1:]:
        threads = -(-(tx + 2 * (2 * e + r + g)) // 32) * 32
        smem = smem_bytes(tx, r, g, e)
        if threads <= 1024 and smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(
            f"CFAR windows {cfg} need {threads} threads and {smem} B of shared memory "
            f"a block (> 1024, {SMEM_LIMIT})"
        )
    strips = sum(-(-(b - a) // tx) for a, b in segments)
    warps = threads // 32
    per_sm = max(1, min(2048 // threads, 32, 233472 // (smem + 1024)))

    def cost(band_rows):
        blocks = batch * strips * -(-nvu // band_rows)
        resident = min(per_sm, -(-blocks // n_sms))
        steps = band_rows + FILL_SHARE * 2 * (g + r)
        return (blocks * steps / (n_sms * resident)
                * (STEP_LATENCY + resident * warps * STEP_ISSUE)
                + steps * (STEP_LATENCY + warps * STEP_ISSUE))

    band_rows = min({-(-nvu // n) for n in range(1, nvu + 1)}, key=lambda b: (cost(b), -b))
    n_bands = -(-nvu // band_rows)
    table, first = [], 0
    for a, b in segments:
        table.append((a, b - a, first))
        first += -(-(b - a) // tx) * n_bands
    return CfarPlan(tx, band_rows, threads, tuple(table), n_bands, first, smem)


def plan_tile(plan: CfarPlan, block: int) -> Tuple[int, int, int, int, int]:
    """``(col0, ns, x0, y_begin, y_end)`` of ``blockIdx.x == block``,
    decoded as the kernel decodes it: the segment, its strip and band; the
    block decides cropped rows ``[y_begin, y_end)`` of columns
    ``[x0, x0 + tx)`` of the segment."""
    s = 0
    while s + 1 < len(plan.table) and block >= plan.table[s + 1][2]:
        s += 1
    col0, ns, first = plan.table[s]
    ct, band = divmod(block - first, plan.n_bands)
    return col0, ns, ct * plan.tx, band * plan.band_rows, (band + 1) * plan.band_rows


def plan_key(
    segments: Sequence[Tuple[int, int]], nvu: int, batch: int, cfg: CFARConfig, n_sms: int
) -> tuple:
    """What shapes a launch's plan: the geometry, the windows, the method and
    the card's SMs.  The threshold is not in it: a threshold sweep reuses
    one plan (the kernel takes the threshold at run time)."""
    return (tuple(segments), nvu, batch, cfg.ref_cells, cfg.guard_cells,
            cfg.range_extend_cells, cfg.method, n_sms)


@functools.lru_cache(maxsize=64)
def _launch_table(segments, nvu: int, batch: int, r: int, g: int, e: int, method: int,
                  n_sms: int):
    """The plan of one launch and its segment table as the C entry point
    takes it (col0[], ns[], first_block[]), built once per :func:`plan_key`."""
    plan = cfar_plan(segments, nvu, batch,
                     CFARConfig(ref_cells=r, guard_cells=g, range_extend_cells=e,
                                method=method), n_sms)
    lib = _build.library()
    if lib.rsp_cascaded_cfar_smem_bytes(plan.tx, r, g, e) != plan.smem:
        raise RuntimeError("cascaded_cfar2d: csrc/cfar.cu and smem_bytes disagree")
    table = (ctypes.c_int * (3 * len(plan.table) + 1))(
        *(c for c, _, _ in plan.table), *(w for _, w, _ in plan.table),
        *(f for _, _, f in plan.table), plan.n_blocks,
    )
    return plan, table


def cascaded_cfar2d(
    rdm: torch.Tensor,
    cfg: CFARConfig,
    n_clutter: int,
    segments: Sequence[Tuple[int, int]] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RDM (..., n_velocity, n_range) float32 -> bool ``(flags, vflags)``.

    ``segments`` (half-open column ranges tiling ``[0, n_range)`` once
    clipped to it, default one segment) each get their own range axis, as
    in ``segmented_cfar``.
    CPU tensor: the plain version.  CUDA tensor: one kernel launch, or an
    exception; ``cascaded_cfar2d.launches`` counts the kernel launches.
    """
    nv, nr = rdm.shape[-2], rdm.shape[-1]
    # clip to the RDM width as slicing does, dropping empty segments
    segments = tuple(
        (a, min(b, nr)) for a, b in (segments or ((0, nr),)) if a < min(b, nr)
    )
    if rdm.device.type == "cpu":
        return segmented_cfar(rdm, segments, cfg, n_clutter)
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
    batch = int(np.prod(rdm.shape[:-2], dtype=np.int64))
    if not 0 < batch <= 65535:
        raise ValueError(f"cascaded_cfar2d: batch {batch} outside 1..65535")

    n_sms = torch.cuda.get_device_properties(rdm.device).multi_processor_count
    plan, table = _launch_table(*plan_key(segments, nvu, batch, cfg, n_sms))
    flags = torch.empty(rdm.shape, dtype=torch.bool, device=rdm.device)
    vflags = torch.empty(rdm.shape, dtype=torch.bool, device=rdm.device)
    stream = torch.cuda.current_stream(rdm.device).cuda_stream
    rc = _build.library().rsp_cascaded_cfar(
        rdm.data_ptr(), flags.data_ptr(), vflags.data_ptr(), batch, nv, nr, lo, nvu,
        len(plan.table), table, plan.tx, plan.band_rows, cfg.ref_cells, cfg.guard_cells,
        cfg.method, float(cfg.threshold), cfg.range_extend_cells, int(cfg.range_detect), stream,
    )
    _build.check(rc, "rsp_cascaded_cfar")
    cascaded_cfar2d.launches += 1
    return flags, vflags


cascaded_cfar2d.launches = 0

"""B1: fused cascaded 2-D CA-CFAR.

Replaces ``radar_signal_process_tpu/kernels/cfar_pallas.py::
cascaded_cfar2d_pallas``.  Flags are bit-identical to
``ops.cfar.segmented_cfar`` (the fifth implementation kept in lockstep:
same summation order, division by float(r), f32 threshold product, edge
fallback, strict ``>`` first-maximum cascade).

On a CUDA tensor :func:`cascaded_cfar2d` launches ``csrc/cfar.cu`` once
per pulse segment.  The kernel is bound by bytes (read the f32 RDM, write
two byte-wide flag maps, ~0.35 GB per G2 window): each block stages a
32 x 64 tile with its velocity and range halos in shared memory once and
keeps the running sums, flags and winner offsets there, so each output byte
is written once.  Global memory needs none of the Pallas kernel's VMEM
range chunking.  On a CPU tensor it runs the plain ``ops.cfar`` version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import CFARConfig
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper


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
    CPU tensor: the plain version.  CUDA tensor: the kernel, or an
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

    lib = _build.library()
    r, g, e = cfg.ref_cells, cfg.guard_cells, cfg.range_extend_cells
    smem = lib.rsp_cascaded_cfar_smem_bytes(r, g, e)
    if smem > SMEM_LIMIT:
        raise ValueError(f"CFAR tile needs {smem} B of shared memory (> {SMEM_LIMIT})")
    flags = torch.empty(rdm.shape, dtype=torch.bool, device=rdm.device)
    vflags = torch.empty(rdm.shape, dtype=torch.bool, device=rdm.device)
    stream = torch.cuda.current_stream(rdm.device).cuda_stream
    t = float(cfg.threshold)
    for a, b in segments:
        rc = lib.rsp_cascaded_cfar(
            rdm.data_ptr(), flags.data_ptr(), vflags.data_ptr(), batch, nv, nr,
            lo, nvu, a, b - a, r, g, cfg.method, t, e, int(cfg.range_detect), stream,
        )
        _build.check(rc, "rsp_cascaded_cfar")
        cascaded_cfar2d.launches += 1
    return flags, vflags


cascaded_cfar2d.launches = 0

"""Range-sharded execution with halo exchange over ``torch.distributed``.

Counterpart of ``radar_signal_process_tpu/parallel/sharding.py``.  The JAX
form is one process driving every device through ``shard_map``; here every
rank is a process that holds its own block and runs the per-rank body, and
each JAX collective is an explicit one on the mesh axis's group:

* ``ppermute`` (the CFAR halo ring)  -> ``batch_isend_irecv``;
* ``all_to_all`` (slow time -> range) -> ``all_to_all_single``;
* ``psum_scatter`` (the tp DBF)       -> ``reduce_scatter_tensor``.

Complex tensors cross every collective as ``view_as_real`` float pairs: not
every c10d path takes complex tensors, and the sum of the real and
imaginary planes is the complex sum.  ``in_specs`` become
:func:`local_block` (cut this rank's block out of a whole array) and
``out_specs`` :func:`gather_blocks` (assemble the blocks on the mesh's
first rank).

Beams, slices and frames are pure data parallelism ("dp"); range is the
sequence-parallel axis ("sp").  Pulse compression runs PRT-sharded (fast
time local), an all-to-all re-shards to range so the slow-time Doppler
transform (B2) is local per range bin, and the CFAR exchanges reference/guard
halos with the neighbour shards.  Halo discipline for the exact cascade: a
cell's mark depends on winners within +-E cells, winners on candidate flags
within +-E, and a candidate flag on ref+guard context, so a halo of
``ref+guard+2E`` columns makes every centre column bit-identical to the
unsharded detector, validity taken on *global* column indices.

The CFAR runs B1 (``kernels.cfar.cascaded_cfar2d``) once per rank on its
halo-extended block, with the block's own segment table
(``kernels.cfar.extended_segments``), and keeps the centre columns; B1's
wrapper runs its plain version on a CPU tensor, so the gloo ranks take the
card's route.  Wrapped halo columns lie in dummy segments of their own, so
the JAX code's phantom-winner mask has nothing to mask here.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from radar_signal_process_tpu_torch.config import CFARConfig, RadarProfile
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d, extended_segments
from radar_signal_process_tpu_torch.models.mtd_pipeline import _form_rdm, slice_cpi_window
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar_flags, segmented_cfar_select
from radar_signal_process_tpu_torch.ops.mtd import (
    istc_compensate, mti_cancel, notch_mask, notch_rows,
)
from radar_signal_process_tpu_torch.ops.pulse_compression import segmented_pulse_compression
from radar_signal_process_tpu_torch.ops.windows import make_window
from radar_signal_process_tpu_torch.parallel.mesh import axis_index, axis_size, mesh_device
from radar_signal_process_tpu_torch.params import chain_params

Spec = Sequence[Optional[str]]


# ------------------------------------------------------------------ blocks
def _as_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous real tensor a collective can carry."""
    x = x.contiguous()
    if x.is_complex():
        return torch.view_as_real(x)
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x


def _from_wire(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(x)
    return x.to(like.dtype)


def local_block(x: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """This rank's block of the whole array ``x``: dim ``i`` split evenly
    over mesh axis ``spec[i]`` (``None``: not split), a view (the
    counterpart of a ``shard_map`` in_spec)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, n_ax = x.shape[dim], axis_size(mesh, ax)
        if n % n_ax:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {ax}={n_ax}")
        x = x.narrow(dim, axis_index(mesh, ax) * (n // n_ax), n // n_ax)
    return x


def shard_batch(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp") -> torch.Tensor:
    """This rank's block of ``x`` with the leading (batch) axis split over
    ``axis``: the counterpart of the JAX ``NamedSharding(mesh, P(axis))``."""
    return local_block(x, mesh, (axis,))


def gather_blocks(x: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> Optional[torch.Tensor]:
    """Every mesh rank's block ``x`` (laid out by ``spec`` as in
    :func:`local_block`) assembled into the whole array on the mesh's first
    rank; ``None`` on its other ranks.  The gather runs over the mesh's own
    ranks (``whole_group``, :func:`parallel.mesh.make_mesh`), so a mesh over
    part of the world leaves the other ranks out.  Blocks of ranks that
    differ only along an axis ``spec`` does not name are replicas; one of
    them is kept."""
    group = getattr(mesh, "whole_group", None)
    if group is None:
        raise TypeError("gather_blocks needs a mesh built by parallel.mesh.make_mesh")
    ranks = mesh.mesh.cpu().numpy()          # global rank at each mesh coordinate
    if ranks.size == 1:
        return x
    wire = _as_wire(x)
    root = int(ranks.flat[0])
    is_root = dist.get_rank() == root
    parts = [torch.empty_like(wire) for _ in range(ranks.size)] if is_root else None
    dist.gather(wire, parts, dst=root, group=group)
    if not is_root:
        return None
    by_rank = {dist.get_global_rank(group, i): part for i, part in enumerate(parts)}
    names = list(mesh.mesh_dim_names)
    shape = list(wire.shape)
    for dim, ax in enumerate(spec):
        if ax is not None:
            shape[dim] *= axis_size(mesh, ax)
    out = torch.empty(shape, dtype=wire.dtype, device=wire.device)
    for coords in np.ndindex(*ranks.shape):
        idx = [slice(None)] * wire.ndim
        for dim, ax in enumerate(spec):
            if ax is not None:
                c, n = coords[names.index(ax)], x.shape[dim]
                idx[dim] = slice(c * n, (c + 1) * n)
        out[tuple(idx)] = by_rank[int(ranks[coords])]
    return _from_wire(out, x)


def _peer(mesh: DeviceMesh, axis: str, step: int) -> int:
    """Global rank of the neighbour ``step`` places along ``axis`` (a ring)."""
    group = mesh.get_group(axis)
    return dist.get_global_rank(group, (axis_index(mesh, axis) + step) % axis_size(mesh, axis))


# ------------------------------------------------------------------ halo CFAR
def halo_exchange(
    x: torch.Tensor, halo: int, mesh: DeviceMesh, axis: str, pad: int = 0
) -> torch.Tensor:
    """Exchange ``halo`` edge columns (last axis) with the ring neighbours
    along ``axis``; returns the block extended to ``local + 2*halo + pad``
    columns, the right halo ``pad`` columns wider (B1 widens its blocks'
    rows to whole 16 bytes, the stride its TMA staging needs).

    Edge shards receive wrapped data in their outer halo; callers keep it
    out by global column index (validity, or B1's dummy segments).  Each rank posts send-right, receive-left,
    send-left, receive-right, the rightward pair under tag 0 and the leftward
    under tag 1: with two ranks the left and right neighbour are one rank,
    and the order (and tags) keep the two transfers from crossing.
    """
    n = axis_size(mesh, axis)
    if n == 1:
        # single shard: wrap (masked by validity downstream)
        return torch.cat([x[..., -halo:], x, x[..., : halo + pad]], dim=-1)
    if x.shape[-1] < halo + pad:
        raise ValueError(f"halo {halo} + {pad} wider than the {x.shape[-1]}-column block")
    group = mesh.get_group(axis)
    right, left = _peer(mesh, axis, 1), _peer(mesh, axis, -1)
    to_right, to_left = _as_wire(x[..., -halo:]), _as_wire(x[..., : halo + pad])
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    ops = [dist.P2POp(dist.isend, to_right, right, group, tag=0),
           dist.P2POp(dist.irecv, from_left, left, group, tag=0),
           dist.P2POp(dist.isend, to_left, left, group, tag=1),
           dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([_from_wire(from_left, x), x, _from_wire(from_right, x)], dim=-1)


def sharded_cfar1d_ref_level(
    x_local: torch.Tensor, cfg: CFARConfig, mesh: DeviceMesh, axis: str, n_global: int
) -> torch.Tensor:
    """Range-dim CFAR reference level for a range-sharded block (last axis):
    the roll form on the halo-extended block, a window valid when it lies
    inside ``[0, n_global)`` by *global* column index, else the opposite
    side's mean is used."""
    local_n = x_local.shape[-1]
    r, g = cfg.ref_cells, cfg.guard_cells
    h = r + g
    ext = halo_exchange(x_local, h, mesh, axis)
    gidx = axis_index(mesh, axis) * local_n + torch.arange(-h, local_n + h, device=ext.device)
    acc = ext
    for k in range(1, r):
        acc = acc + torch.roll(ext, k, dims=-1)
    r_t = torch.tensor(float(r), dtype=ext.dtype, device=ext.device)
    left_mean = torch.roll(acc, g + 1, dims=-1) / r_t
    right_mean = torch.roll(acc, -(g + r), dims=-1) / r_t
    left_used = torch.where(gidx - h >= 0, left_mean, right_mean)
    right_used = torch.where(gidx + h <= n_global - 1, right_mean, left_mean)
    pick = torch.maximum if cfg.method == 0 else torch.minimum
    return pick(left_used, right_used)[..., h : h + local_n]


def extended_block_cfar(
    ext: torch.Tensor,
    cfg: CFARConfig,
    n_clutter: int,
    n_global: int,
    segments: Sequence[Tuple[int, int]],
    col0: int,
    local_n: int,
    halo: int,
    zero_rows: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 once over a halo-extended block (all rows, ``local_n + 2*halo``
    columns starting at global column ``col0 - halo``, and any columns past
    them, ``halo_exchange``'s ``pad``) with the block's segment table, whose
    last segment takes the columns past; returns the centre columns'
    ``(flags, vflags)``, equal bit for bit to ``segmented_cfar`` over the
    whole RDM (re-notched on ``zero_rows``, as B1 reads them): the columns
    past lie beyond every window of a centre column and of its cascade
    candidates.  On a CPU tensor B1's wrapper runs its plain version over
    the same table."""
    table = extended_segments(n_global, segments or ((0, n_global),), col0, local_n, halo)
    table = table[:-1] + ((table[-1][0], ext.shape[-1]),)
    flags, vflags = cascaded_cfar2d(ext.contiguous(), cfg, n_clutter, table, zero_rows=zero_rows)
    return flags[..., halo : halo + local_n], vflags[..., halo : halo + local_n]


def sharded_cascaded_cfar2d(
    rdm_local: torch.Tensor,
    cfg: CFARConfig,
    n_clutter: int,
    mesh: DeviceMesh,
    axis: str,
    n_global: int,
    segments: Sequence[Tuple[int, int]] = (),
    zero_rows: Tuple[int, int] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range-sharded cascaded 2-D CFAR, bit-identical to the unsharded op.

    ``rdm_local``: (..., n_velocity, local_range), range sharded over
    ``axis``.  With ``segments`` (global half-open column ranges tiling
    ``[0, n_global)``, the reference's pulse-type split) the result matches
    ``ops.cfar.segmented_cfar``; shard boundaries need not align with the
    segments.  Each rank runs B1 once on its halo-extended block
    (:func:`extended_block_cfar`), its rows widened to whole 16 bytes; with
    one rank on ``axis`` no column lies outside the block, and B1 runs on it
    as it is.  ``zero_rows`` is B1's: the re-notch fused into its load.
    Parity with the JAX package's roll form holds above the floor of ROADMAP
    C3 (each segment wider than 2(ref+guard)+1 columns, the cropped rows
    more than 2(ref+guard)).
    """
    if axis_size(mesh, axis) == 1:
        return cascaded_cfar2d(rdm_local.contiguous(), cfg, n_clutter,
                               segments or ((0, n_global),), zero_rows=zero_rows)
    local_n = rdm_local.shape[-1]
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    ext = halo_exchange(rdm_local, h, mesh, axis, pad=-(local_n + 2 * h) % 4)
    return extended_block_cfar(ext, cfg, n_clutter, n_global, segments,
                               axis_index(mesh, axis) * local_n, local_n, h, zero_rows)


# ----------------------------------------------------------------- pipelines
def _cfar_segments(profile: RadarProfile, segmented: bool) -> Tuple[Tuple[int, int], ...]:
    """The profile's CFAR segments, or none: a table whose last stop is not
    ``point_prt`` is stale for the geometry (e.g. a cut dry-run profile),
    and whole-width CFAR beats bounds that admit wrapped halo data."""
    segments = tuple(profile.cfar_segments) if segmented else ()
    if segments and segments[-1][1] != profile.point_prt:
        return ()
    return segments


def slow_to_range(pc: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """(..., prt_local, n_points) slow-time-sharded -> (..., n_prt,
    points_local) range-sharded over ``axis`` (JAX ``all_to_all(split_axis=-1,
    concat_axis=-2, tiled=True)``).

    The fast-time axis is cut into one chunk per rank, the rank axis moved
    to the front for ``all_to_all_single``, and the received chunks (one per
    source rank, in rank order) concatenated along slow time: rank ``j``'s
    chunk holds PRTs ``[j*prt_local, (j+1)*prt_local)``.  Another order would
    scramble slow time and still give plausible-looking RDMs.
    """
    n = axis_size(mesh, axis)
    if n == 1:
        return pc
    *lead, p_loc, n_pts = pc.shape
    if n_pts % n:
        raise ValueError(f"{n_pts} range points do not split over {axis}={n}")
    chunks = pc.reshape(*lead, p_loc, n, n_pts // n).movedim(-2, 0)
    send = _as_wire(chunks)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    out = _from_wire(recv, pc)                        # (n, ..., p_loc, pts_loc)
    return out.movedim(0, -3).reshape(*lead, n * p_loc, n_pts // n)


@functools.lru_cache(maxsize=16)
def _notch_keep(n: int, divisor: int, device: torch.device) -> torch.Tensor:
    """(n, 1) float32 keep-mask of the zero-velocity notch, on ``device``."""
    return torch.as_tensor(notch_mask(n, divisor), device=device)[:, None]


def _notch(rdm: torch.Tensor, divisor: int | None) -> torch.Tensor:
    """``ops.mtd.zero_velocity_notch`` with the mask built once per shape and
    device."""
    return rdm * _notch_keep(rdm.shape[-2], divisor, rdm.device) if divisor else rdm


def _renotch_rows(n_v: int, divisor: int | None) -> Tuple[int, int] | None:
    """The detection stage's wide re-notch (``ops.mtd.zero_velocity_notch``,
    ``main_cfar.m:90-91``) as B1's ``zero_rows``, or None for none."""
    if not divisor:
        return None
    lo, hi = notch_rows(n_v, divisor)
    return lo, hi + 1


def make_sharded_pipeline(
    profile: RadarProfile,
    mesh: DeviceMesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    sp_axis: str = "sp",
    segmented: bool = True,
    renotch_divisor: int | None = None,
):
    """Per-rank step of the sharded chain: echo -> RDM -> CFAR flags.

    * ``dp`` shards the beam axis (pure data parallelism);
    * ``sp`` shards slow time during pulse compression, then an all-to-all
      re-shards to range for the Doppler stage (B2) and the CFAR (B1 on the
      halo-extended block).

    Returns ``run(echo_local) -> (rdm, flags, vflags)``: ``echo_local`` is
    this rank's block ``local_block(echo, mesh, (dp, sp, None))`` of the
    (n_beams, n_pulses, n_points) complex64 echo, the results its block
    ``(dp, None, sp)`` of the (n_beams, n_fft, n_points) outputs.  With
    ``segmented`` the CFAR honours the profile's pulse-type segments
    (dropped when stale, :func:`_cfar_segments`).  ``renotch_divisor``
    applies the detection stage's wide clutter re-notch in B1's load
    (``zero_rows``), while the returned RDM keeps only the MTD-stage notch.
    """
    cfg = cfg or profile.cfar
    segments = _cfar_segments(profile, segmented)
    device = mesh_device(mesh)
    params = {}

    def run(echo_local: torch.Tensor):
        n_points = echo_local.shape[-1]
        n_pulses = echo_local.shape[-2] * axis_size(mesh, sp_axis)
        if n_pulses not in params:
            params[n_pulses] = chain_params(profile, device=device, n_pulses=n_pulses)
        p = params[n_pulses]
        pc = segmented_pulse_compression(echo_local, profile, p.pc_spectra, p.pc_filter_lens)
        pc = slow_to_range(pc, mesh, sp_axis)
        rdm = _form_rdm(pc, profile, p)
        flags, vflags = sharded_cascaded_cfar2d(
            rdm, cfg, n_clutter, mesh, sp_axis, n_points, segments,
            _renotch_rows(rdm.shape[-2], renotch_divisor))
        return rdm, flags, vflags

    return run


def make_sharded_stream(
    profile: RadarProfile,
    mesh: DeviceMesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    win_size: int = 4,
    sp_axis: str = "sp",
    segmented: bool = True,
    renotch_divisor: int | None = None,
    stc_curve_db=None,
    pulses=None,
):
    """Steady-state streaming on a mesh with per-frame PC reuse.

    Each doubled-CPI window spans frames N and N+1, so every frame's
    compressed rows feed two windows: the compressed, range-sharded frame
    is the state carried between windows, and each step compresses only the
    arriving frame (sp-sharded slow time -> all-to-all -> range), joins it
    to the carried one and runs the ``win_size`` slices through MTI, B2 and
    the halo CFAR.

    Returns ``(init, step)`` over this rank's blocks:

    * ``init(frame_local) -> pc_state`` compresses the first frame;
    * ``step(pc_state, frame_next_local) -> (pc_next, rdms, flags, vflags)``
      advances one window; ``rdms``/``flags`` are the block ``(dp, None,
      None, sp)`` of the (n_beams, win_size, n_prt, n_points) stacks.

    ``frame_local`` is ``local_block(frame, mesh, (dp, sp, None))`` of an
    (n_beams, n_prt, n_points) complex64 frame.  ``stc_curve_db`` /
    ``pulses`` are the iSTC and measured-matched-filter hooks (both are
    fast-time-row local, so per-frame application before compression
    matches the window-level semantics).
    """
    cfg = cfg or profile.cfar
    segments = _cfar_segments(profile, segmented)
    device = mesh_device(mesh)
    params = {}

    def chain(n_prt: int):
        if n_prt not in params:
            params[n_prt] = chain_params(profile, pulses=pulses, stc_curve_db=stc_curve_db,
                                         device=device, n_pulses=n_prt)
        return params[n_prt]

    def compress(echo_local: torch.Tensor) -> torch.Tensor:
        p = chain(echo_local.shape[-2] * axis_size(mesh, sp_axis))
        if profile.mtd.istc and p.stc_gain is not None:
            echo_local = istc_compensate(echo_local, p.stc_gain)
        pc = segmented_pulse_compression(echo_local, profile, p.pc_spectra, p.pc_filter_lens)
        return slow_to_range(pc, mesh, sp_axis)        # the carry's layout

    def step(pc_prev: torch.Tensor, echo_local: torch.Tensor):
        n_points = echo_local.shape[-1]
        pc_next = compress(echo_local)
        slices = slice_cpi_window(torch.cat([pc_prev, pc_next], dim=-2), win_size)
        if profile.mtd.mti_lag:
            slices = mti_cancel(slices, lag=profile.mtd.mti_lag)
        rdm = _form_rdm(slices, profile, chain(pc_prev.shape[-2]))
        flags, vflags = sharded_cascaded_cfar2d(
            rdm, cfg, n_clutter, mesh, sp_axis, n_points, segments,
            _renotch_rows(rdm.shape[-2], renotch_divisor))
        return pc_next, rdm, flags, vflags

    return compress, step


def make_sharded_e2e(
    profile: RadarProfile,
    mesh: DeviceMesh,
    dbf_coeffs,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    sp_axis: str = "sp",
    tp_axis: str = "tp",
    segmented: bool = True,
):
    """Raw-channel cube -> detections over a 3-axis (dp, sp, tp) mesh.

    * **tp** shards the DBF contraction: each rank holds a channel subset of
      the raw I/Q and the matching coefficient columns, forms its partial
      ``(..., samples, beams)`` product, and a reduce-scatter over the beam
      axis completes the sum while leaving each tp rank a distinct beam
      subset (the beam axis then acts as data parallelism downstream).
      Its channel sum runs in another order than one einsum's: RDMs agree to
      a tolerance, and flags are held by rerunning the CFAR on the RDM;
    * **dp** shards the frame batch;
    * **sp** shards slow time through pulse compression, re-shards to range
      and exchanges CFAR halos.

    Returns ``run(iq_local) -> (rdm, flags, vflags)``: ``iq_local`` is the
    block ``(dp, sp, None, tp)`` of the (n_frames, n_prt, n_samples,
    n_channels) complex64 cube, the results the block ``(dp, tp, None, sp)``
    of the (n_frames, n_beams, n_fft, n_samples) outputs.
    """
    cfg = cfg or profile.cfar
    device = mesh_device(mesh)
    coeffs = torch.as_tensor(np.asarray(dbf_coeffs), dtype=torch.complex64, device=device)
    n_beams = coeffs.shape[0]
    n_tp = axis_size(mesh, tp_axis)
    if n_beams % n_tp:
        raise ValueError(f"n_beams {n_beams} not divisible by tp={n_tp}")
    coeffs_local = local_block(coeffs, mesh, (None, tp_axis)).contiguous()
    segments = _cfar_segments(profile, segmented)
    params = {}

    def run(iq_local: torch.Tensor):
        partial = torch.einsum("fpsc,bc->fpsb", iq_local, coeffs_local)
        if n_tp > 1:
            # complete the channel sum; scatter the beam axis across tp
            send = _as_wire(partial.movedim(-1, 0))       # (beams, f, p, s, 2)
            recv = torch.empty((n_beams // n_tp,) + send.shape[1:], dtype=send.dtype,
                               device=send.device)
            dist.reduce_scatter_tensor(recv, send, group=mesh.get_group(tp_axis))
            echo = _from_wire(recv, partial).movedim(0, 1)
        else:
            echo = partial.movedim(-1, 1)
        echo = echo.contiguous()                          # (f, beams_local, p, s)
        n_points = echo.shape[-1]
        n_pulses = echo.shape[-2] * axis_size(mesh, sp_axis)
        if n_pulses not in params:
            params[n_pulses] = chain_params(profile, device=device, n_pulses=n_pulses)
        p = params[n_pulses]
        pc = segmented_pulse_compression(echo, profile, p.pc_spectra, p.pc_filter_lens)
        pc = slow_to_range(pc, mesh, sp_axis)
        rdm = _form_rdm(pc, profile, p)
        flags, vflags = sharded_cascaded_cfar2d(rdm, cfg, n_clutter, mesh, sp_axis, n_points,
                                                segments)
        return rdm, flags, vflags

    return run


# ---------------------------------------------------------- pipeline-parallel
def make_pipeline_parallel(
    profile: RadarProfile,
    mesh: DeviceMesh,
    cfg: CFARConfig | None = None,
    n_clutter: int = 14,
    pp_axis: str = "pp",
    segmented: bool = True,
):
    """GPipe-style pipeline parallelism over the radar chain stages.

    The chain is cut into ``pp`` stages, one per rank along ``pp_axis``:

    * 2 stages: [pulse compression | Doppler + notch + CFAR]
    * 3 stages: [pulse compression | windowed Doppler transform |
      magnitude + notch + CFAR]
    * 4 stages: [pulse compression | windowed Doppler transform |
      magnitude + notch + CFAR flag planes | cascade select].

    Microbatches (beams) flow through the stage ring: each of the ``n_micro
    + pp - 1`` ticks every rank applies its stage to its in-flight
    microbatch and sends the activation to the next stage while stage 0
    ingests the next microbatch.  Activations are one ``(n_act, n_points)``
    complex64 buffer, ``n_act = max(n_pulses, mtd.fft_length)``; flag planes
    ride the imaginary part (stage 3 encodes ``vflag + 2*rflag``, the last
    stage ``rdm + 1j*flags``).  The Doppler transform is ``torch.fft`` at
    every depth, and the cascade B1 (or its plain version on the CPU) or the
    plain split forms at depth 4.

    Returns ``run(echo) -> (rdm, flags)``: ``echo`` (n_micro, n_pulses,
    n_points) is the same on every rank, and every rank gets the last
    stage's outputs.
    """
    cfg = cfg or profile.cfar
    n_pp = axis_size(mesh, pp_axis)
    if n_pp not in (2, 3, 4):
        raise ValueError(f"pipeline depth must be 2, 3 or 4, got {n_pp}")
    segments = _cfar_segments(profile, segmented)
    device = mesh_device(mesh)
    params = chain_params(profile, device=device)

    def _build_stages(n_pulses: int):
        n_fft = profile.mtd.fft_length or n_pulses
        if n_fft < n_pulses:
            raise ValueError(f"mtd.fft_length {n_fft} < n_pulses {n_pulses}")
        window = torch.as_tensor(
            make_window(profile.mtd.window, n_pulses, profile.mtd.window_beta),
            dtype=torch.float32, device=device)[:, None]

        def s_pc(x):
            # zero pad rows compress to zero, so the padded buffer passes
            # through the segmented compressor unchanged in the real rows
            return segmented_pulse_compression(x, profile, params.pc_spectra,
                                               params.pc_filter_lens)

        def _spec(x):
            pc = x[..., :n_pulses, :]
            if profile.mtd.mti_lag:
                pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
            spec = torch.fft.fft(pc * window, n=n_fft, dim=-2)
            return torch.fft.fftshift(spec, dim=-2) if profile.mtd.fftshift else spec

        def _notched(rdm):
            return _notch(rdm, profile.mtd.notch_divisor)

        def _segs(rdm):
            return segments or ((0, rdm.shape[-1]),)

        def _cascade(rdm):
            flags, _ = cascaded_cfar2d(rdm.contiguous(), cfg, n_clutter, _segs(rdm))
            return rdm + 1j * flags.to(rdm.dtype)

        def s_rdm_cfar(x):      # 2-stage tail: PC activation in
            return _cascade(_notched(_spec(x).abs()))

        def s_mag_cfar(x):      # 3-stage tail: complex spectrum in
            return _cascade(_notched(x.abs()))

        def s_mag_flags(x):     # 4-stage: flag planes ride the imag part
            rdm = _notched(x.abs())
            vflag, rflag = segmented_cfar_flags(rdm, _segs(rdm), cfg, n_clutter)
            enc = torch.zeros_like(rdm)
            enc[..., n_clutter + 1 : n_clutter + 1 + vflag.shape[-2], :] = (
                vflag.to(rdm.dtype) + 2.0 * rflag.to(rdm.dtype))
            return rdm + 1j * enc

        def s_select(x):        # 4-stage tail: resolve cascade winners
            rdm, enc = x.real, x.imag
            enc_used = enc[..., n_clutter + 1 : rdm.shape[-2] - n_clutter, :]
            vflag = torch.remainder(enc_used, 2.0) >= 0.5
            rflag = enc_used >= 1.5
            flags, _ = segmented_cfar_select(rdm, vflag, rflag, _segs(rdm), cfg, n_clutter)
            return rdm + 1j * flags.to(rdm.dtype)

        stages = {2: [s_pc, s_rdm_cfar], 3: [s_pc, _spec, s_mag_cfar],
                  4: [s_pc, _spec, s_mag_flags, s_select]}[n_pp]
        return stages, n_fft

    def run(echo: torch.Tensor):
        n_pulses = echo.shape[-2]
        stages, n_act = _build_stages(n_pulses)
        if n_pulses < n_act:
            pad = echo.new_zeros(echo.shape[:-2] + (n_act - n_pulses, echo.shape[-1]))
            echo = torch.cat([echo, pad], dim=-2)
        n_micro = echo.shape[0]
        stage = axis_index(mesh, pp_axis)
        group = mesh.get_group(pp_axis)
        nxt, prv = _peer(mesh, pp_axis, 1), _peer(mesh, pp_axis, -1)
        buf = echo[0] if stage == 0 else torch.zeros_like(echo[0])
        outs = []
        for t in range(n_micro + n_pp - 1):
            y = stages[stage](buf).to(torch.complex64).contiguous()
            send, recv = _as_wire(y), torch.empty_like(_as_wire(y))
            for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                               dist.P2POp(dist.irecv, recv, prv, group)]):
                req.wait()
            if stage == 0:
                buf = echo[t + 1] if t + 1 < n_micro else torch.zeros_like(echo[0])
            else:
                buf = _from_wire(recv, y)
            if stage == n_pp - 1 and t >= n_pp - 1:
                outs.append(y)                            # the drained tail
        out = (torch.stack(outs) if outs else
               torch.empty((n_micro,) + tuple(echo.shape[1:]), dtype=torch.complex64,
                           device=echo.device))
        wire = _as_wire(out)
        dist.broadcast(wire, _peer(mesh, pp_axis, n_pp - 1 - stage), group=group)
        out = _from_wire(wire, out)
        return out.real, out.imag > 0.5

    return run


# ------------------------------------------------------------ expert-parallel
def make_expert_parallel(
    profile: RadarProfile,
    mesh: DeviceMesh,
    calibrations,
    ep_axis: str = "ep",
    capacity: int | None = None,
):
    """Expert parallelism: per-beam calibration experts with MoE routing.

    Each beam's receive-gain calibration curve is an "expert"; the table is
    sharded over ``ep_axis``, one beam group per rank.  Frames go to the
    rank that owns their beam's curve with the MoE dispatch: a stable sort
    by destination, buckets of static ``capacity``, one all-to-all,
    expert-local calibration and segmented pulse compression, a second
    all-to-all and the un-scatter that restores frame order.  Frames beyond
    a bucket's capacity drop (zero output); the default capacity (the
    frames of one rank) never drops.

    ``calibrations``: (n_beams, n_points) real gain curves, n_beams
    divisible by the ep size.  Returns ``run(frames, beam_ids) ->
    compressed``: ``frames`` (n_frames, n_pulses, n_points) complex64 and
    ``beam_ids`` (n_frames,) are the same on every rank (checked on the host:
    an out-of-range id raises, on every rank alike); the result is this
    rank's block ``(ep, None, None)`` of
    ``segmented_pulse_compression(frames * calibrations[beam_ids][:, None, :])``.
    """
    device = mesh_device(mesh)
    params = chain_params(profile, device=device)
    cal = torch.as_tensor(np.asarray(calibrations), dtype=torch.float32, device=device)
    n_beams = cal.shape[0]
    n_ep = axis_size(mesh, ep_axis)
    if n_beams % n_ep:
        raise ValueError(f"n_beams {n_beams} not divisible by ep={n_ep}")
    beams_per = n_beams // n_ep
    cal_local = local_block(cal, mesh, (ep_axis, None))
    group = mesh.get_group(ep_axis)

    def exchange(x: torch.Tensor) -> torch.Tensor:
        send = _as_wire(x)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return _from_wire(recv, x)

    def run(frames: torch.Tensor, beam_ids) -> torch.Tensor:
        ids = np.asarray(beam_ids)
        if ids.size and (ids.min() < 0 or ids.max() >= n_beams):
            bad = ids[(ids < 0) | (ids >= n_beams)]
            raise ValueError(f"beam_ids out of range [0, {n_beams}): {bad[:8].tolist()}")
        x = local_block(frames, mesh, (ep_axis, None, None))
        bid = local_block(torch.as_tensor(ids, dtype=torch.int64, device=x.device), mesh,
                          (ep_axis,))
        f_local = x.shape[0]
        cap = capacity or f_local
        dest = torch.div(bid, beams_per, rounding_mode="floor")     # owning rank
        order = torch.argsort(dest, stable=True)
        sdest = dest[order]
        group_start = torch.searchsorted(sdest, torch.arange(n_ep, device=x.device))
        rank_in = torch.arange(f_local, device=x.device) - group_start[sdest]
        kept = rank_in < cap

        send = x.new_zeros((n_ep, cap) + tuple(x.shape[1:]))
        send[sdest[kept], rank_in[kept]] = x[order][kept]
        send_bid = torch.full((n_ep, cap), -1, dtype=torch.int64, device=x.device)
        send_bid[sdest[kept], rank_in[kept]] = bid[order][kept]
        recv, recv_bid = exchange(send), exchange(send_bid)

        # expert-local compute: calibrate by the frame's own beam curve, then
        # compress; empty slots (id -1) give zeros
        local_beam = (recv_bid - axis_index(mesh, ep_axis) * beams_per).clamp(0, beams_per - 1)
        gain = torch.where((recv_bid >= 0)[..., None], cal_local[local_beam], 0.0)
        y = segmented_pulse_compression(recv * gain[..., None, :].to(recv.dtype), profile,
                                        params.pc_spectra, params.pc_filter_lens)
        back = exchange(y.contiguous())
        gathered = back[sdest, rank_in.clamp(max=cap - 1)]
        gathered = torch.where(kept[:, None, None], gathered, 0.0)
        out = torch.zeros_like(gathered)
        out[order] = gathered
        return out

    return run

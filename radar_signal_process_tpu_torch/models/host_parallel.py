"""Block-pipelined stream: per-frame pulse-compression reuse, a block of
windows per device pass.

Port of ``radar_signal_process_tpu/models/host_parallel.py``.  In a stream,
window ``w`` spans frames ``w`` and ``w+1``, so each frame's rows feed two
windows.  Compression runs per row, so each frame is compressed once and
both windows reuse it.  A block of K windows (K+1 frames) then makes one
device pass: one ``slice_cpi_window`` of the joined compressed frames, MTI,
one RDM-former launch (B2) over every (window, beam, slice), the
divisor-20 re-notch, one cascaded-CFAR launch (B1) and one detection
extraction.  Every function takes ``device=`` (``"cuda"`` unless the caller
asks for the CPU, where the kernels' plain versions run).

The JAX module's functions and their ports (the ``cpu_`` prefix goes: these
run on ``device``):

* ``EMIT_MODES``, ``_frame_probe``            -> the same names;
* ``make_cpu_stream_pipeline``               -> :func:`make_stream_pipeline`;
* ``make_cpu_stream_detector``               -> :func:`make_stream_detector`;
* ``make_cpu_stream_processor``              -> :func:`make_stream_processor`;
* ``make_cpu_flags``                         -> :func:`make_flags`;
* ``make_cpu_frame_processor``               -> ``models.mtd_pipeline.FrameProcessor``
  (the same function of a frame pair; it compresses the doubled window).

Not ported: the host-thread schedulers ``_thread_map``,
``two_phase_beam_map`` and ``pipelined_window_map``; the range-major
per-item stages ``make_stream_stage_fns`` and ``_make_detect_item``; the
numpy write buffers ``_alloc_detect_buffers`` and ``_write_detect_outputs``
(and with them the pipeline's ``n_chunks``, the schedulers' beam chunks).
They fan (chunk, beam, slice) items over host threads because XLA's CPU
runtime runs the thunks of one executable in sequence.  torch's CPU
operators are already parallel within each call, and on the card 52
launches a window, one per RDM, would cost far more than one launch over
the block.  What the schedulers guarantee stays: windows come out in
order, later frames may be callables (live ingest), raw frames are
released once compressed, and errors re-raise.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import CFARConfig, RadarProfile
from radar_signal_process_tpu_torch.device import COMPLEX, REAL, resolve_device
from radar_signal_process_tpu_torch.models.detect import (
    RENOTCH_DIVISOR,
    make_cascade_detector,
    make_split_detector,
)
from radar_signal_process_tpu_torch.models.mtd_pipeline import _form_rdm, slice_cpi_window
from radar_signal_process_tpu_torch.ops.measure import DetectionList, extract_detections
from radar_signal_process_tpu_torch.ops.mtd import istc_compensate, mti_cancel
from radar_signal_process_tpu_torch.ops.pulse_compression import (
    range_concatenate,
    segmented_pulse_compression,
)
from radar_signal_process_tpu_torch.params import chain_params

EMIT_MODES = ("detections", "flags", "full")


def _frame_probe(frame: torch.Tensor) -> torch.Tensor:
    """Strided content sample of a frame for the ``frame_idx`` reuse cache.

    It spans every beam and the whole PRT and range extent (a few KB), so
    frames that agree only in their leading samples (blanked leading range
    cells are common in real captures) cannot reuse a stale compression.
    """
    sp = max(1, frame.shape[-2] // 7)
    ss = max(1, frame.shape[-1] // 23)
    return frame[..., ::sp, ::ss].clone()


def _make_block_rdms(profile: RadarProfile, win_size: int, stc_curve_db, pulses,
                     device: torch.device, concat=()):
    """``rdms_of(frames, carry=None) -> (rdms, last)``: K+1 frames
    (n_beams, n_prt, n_pts) complex64 -> the (K, n_beams, win_size, n_prt,
    n_pts) RDMs of their K windows, and the last frame compressed.

    ``frames[0]`` must be a tensor; later entries may be callables that
    return one.  ``carry`` is ``frames[0]`` compressed, which then is not
    compressed again.  Each frame is compressed once (iSTC first, when the
    profile asks for it), re-concatenated by ``concat`` where given (then
    ``n_pts`` is the table's width) and copied into one joined buffer; its
    raw tensor and its compressed tensor are dropped at once, the last
    compressed frame excepted.
    """
    params = chain_params(profile, pulses=pulses, stc_curve_db=stc_curve_db, device=device)
    use_stc = profile.mtd.istc and params.stc_gain is not None

    def compress(frame: torch.Tensor) -> torch.Tensor:
        if use_stc:
            frame = istc_compensate(frame, params.stc_gain)
        pc = segmented_pulse_compression(frame, profile, params.pc_spectra,
                                         params.pc_filter_lens)
        return range_concatenate(pc, concat) if concat else pc

    def rdms_of(frames, carry: Optional[torch.Tensor] = None):
        frames = list(frames)
        if not isinstance(frames[0], torch.Tensor):
            raise ValueError("frames[0] must be a tensor")
        n_beams, n = frames[0].shape[:2]
        n_pts = concat[-1][1] if concat else frames[0].shape[-1]
        joined = torch.empty((n_beams, len(frames) * n, n_pts), dtype=COMPLEX, device=device)
        for i in range(len(frames)):
            if i == 0 and carry is not None:
                pc = carry
            else:
                frame = frames[i]() if callable(frames[i]) else frames[i]
                frames[i] = None          # the raw frame is dead once compressed
                pc = compress(frame)
                del frame
            joined[:, i * n : (i + 1) * n] = pc
        if len(frames) < 2:
            return None, pc
        # (K, n_beams, 2n, n_pts): window w is rows [w n, (w+2) n), a view
        windows = joined.unfold(-2, 2 * n, n).movedim(-1, -2).movedim(-3, 0)
        sl = slice_cpi_window(windows, win_size)
        del joined, windows
        if profile.mtd.mti_lag:
            sl = mti_cancel(sl, lag=profile.mtd.mti_lag)
        return _form_rdm(sl, profile, params), pc

    return rdms_of


class _FrameCache:
    """The compressed ``frame_next`` of the last call, under its frame index
    and content probe: reused only for the same index and the same probe."""

    def __init__(self):
        self._entry: Optional[tuple] = None

    def take(self, frame_idx, frame: torch.Tensor) -> Optional[torch.Tensor]:
        entry, self._entry = self._entry, None
        if (frame_idx is None or entry is None or entry[0] != frame_idx
                or not torch.equal(entry[2], _frame_probe(frame))):
            return None
        return entry[1]

    def keep(self, frame_idx, frame: torch.Tensor, pc: torch.Tensor) -> None:
        if frame_idx is not None:
            self._entry = (frame_idx + 1, pc, _frame_probe(frame))


def make_stream_pipeline(
    profile: RadarProfile,
    win_size: int = 4,
    n_clutter: int = 14,
    cfg: CFARConfig | None = None,
    max_detections: int = 64,
    stc_curve_db=None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    pulses=None,
    emit: str = "full",
    device: str | torch.device = "cuda",
    concat=(),
):
    """Block runner: ``run(frames, emit_cb, carry=None) -> last``.

    ``frames`` are K+1 consecutive (n_beams, n_prt, n_pts) complex64 frames
    on ``device``; ``frames[0]`` must be a tensor, later entries may be
    callables (live ingest).  The block makes one device pass (module
    docstring): B2 and B1 launch once each over its K · n_beams · win_size
    RDMs, so a block is bounded by the kernels' batch limit (65535; the
    wrappers raise above it).  ``emit_cb(w, rdms, flags, dets, hits)`` runs
    once per window, in index order: ``rdms`` (n_beams, win_size, n_prt,
    n_pts) and ``flags`` are views of the block's stacks, ``None`` where
    ``emit`` drops them; ``dets`` the window's ``DetectionList``; ``hits``
    its cascade-flag count, summed on the device with one host
    synchronisation per block.  A failing ``emit_cb`` aborts the run.

    ``carry`` is ``frames[0]`` compressed (the ``last`` of the previous
    block), so a stream compresses every frame exactly once; ``last`` is
    the last frame compressed, its columns re-concatenated by ``concat``
    (``config.range_concat``) where given.  On a CPU ``device`` the CFAR is
    the native cascade, or the split form where it cannot be built
    (``make_cascade_detector``, transposed layout).
    """
    if emit not in EMIT_MODES:
        raise ValueError(f"emit must be one of {EMIT_MODES}, got {emit!r}")
    device = resolve_device(device)
    rdms_of = _make_block_rdms(profile, win_size, stc_curve_db, pulses, device, concat)
    detect = make_cascade_detector(profile, n_clutter, cfg=cfg, renotch_divisor=renotch_divisor,
                                   transposed=True, device=device)

    def run(frames, emit_cb: Callable, carry: Optional[torch.Tensor] = None) -> torch.Tensor:
        rdms, last = rdms_of(frames, carry)
        if rdms is None:
            return last
        flags = detect(rdms.mT)[0].mT
        dets = extract_detections(flags, rdms, max_detections)
        hits = flags.sum(dim=tuple(range(1, flags.ndim))).tolist()
        for w, h in enumerate(hits):
            emit_cb(w, rdms[w] if emit == "full" else None,
                    None if emit == "detections" else flags[w],
                    DetectionList(*(x[w] for x in dets)), h)
        return last

    return run


def make_stream_detector(
    profile: RadarProfile,
    win_size: int = 4,
    n_clutter: int = 14,
    cfg: CFARConfig | None = None,
    max_detections: int = 64,
    stc_curve_db=None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    pulses=None,
    device: str | torch.device = "cuda",
):
    """``process(frame_now, frame_next, frame_idx=None) -> (rdms, flags,
    DetectionList)`` for one window: :func:`make_stream_pipeline` over a
    block of one.  Over consecutive ``frame_idx`` each frame is compressed
    once; a frame whose content probe differs from the cached one's is
    compressed again."""
    run = make_stream_pipeline(profile, win_size, n_clutter, cfg, max_detections, stc_curve_db,
                               renotch_divisor, pulses, emit="full", device=device)
    cache = _FrameCache()

    def process(frame_now, frame_next, frame_idx=None):
        out: list = []
        last = run([frame_now, frame_next], lambda w, r, f, d, h: out.append((r, f, d)),
                   carry=cache.take(frame_idx, frame_now))
        cache.keep(frame_idx, frame_next, last)
        return out[0]

    return process


def make_stream_processor(
    profile: RadarProfile,
    win_size: int = 4,
    stc_curve_db=None,
    pulses=None,
    device: str | torch.device = "cuda",
):
    """``process(frame_now, frame_next, frame_idx=None)`` -> the
    (n_beams, win_size, n_prt, n_pts) RDM stack of the pair (one B2 launch).
    Over consecutive ``frame_idx`` each frame is compressed once and reused
    for both windows it feeds; a changed content probe recompresses."""
    device = resolve_device(device)
    rdms_of = _make_block_rdms(profile, win_size, stc_curve_db, pulses, device)
    cache = _FrameCache()

    def process(frame_now, frame_next, frame_idx=None) -> torch.Tensor:
        rdms, last = rdms_of([frame_now, frame_next], cache.take(frame_idx, frame_now))
        cache.keep(frame_idx, frame_next, last)
        return rdms[0]

    return process


def make_flags(
    profile: RadarProfile,
    n_clutter: int,
    cfg: CFARConfig | None = None,
    renotch_divisor: int | None = RENOTCH_DIVISOR,
    device: str | torch.device = "cuda",
):
    """``flags_fn(rdms) -> (flags, vflags)`` over an RDM stack (..., n_v,
    n_r) of any leading shape, a tensor or a numpy array, on ``device``: one
    :func:`make_split_detector` call, so one B1 launch on the card."""
    device = resolve_device(device)
    detect = make_split_detector(profile, n_clutter, cfg=cfg, renotch_divisor=renotch_divisor,
                                 device=device)

    def flags_fn(rdms) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(rdms, np.ndarray):
            rdms = torch.from_numpy(np.ascontiguousarray(rdms, np.float32))
        return detect(rdms.to(device=device, dtype=REAL))

    return flags_fn

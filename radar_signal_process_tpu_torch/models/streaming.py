"""Streaming execution: overlapped host ingest + device compute.

Port of ``radar_signal_process_tpu/models/streaming.py``.  A background
thread parses ``.bin`` frames and stages each into pinned host memory while
the device processes earlier frames: a G2 frame as it is parsed, a G1
frame's two beams side by side in one block (:class:`TwoBeamReader`).  The
consumer copies a frame to the device on the current stream and beamforms
it there when DBF coefficients are given.  A window's device work is issued
on that one stream (a graph replays there too), so no cross-stream events
are needed; the pinned copy makes the host-to-device transfer asynchronous.
Two consumers:

* the windowed path pairs each frame with the previous one into a
  doubled-CPI window (``main_produce_dataset_win_xzr_v2.m:75-103``) and runs
  the frame processor and the detector over every (beam, slice) RDM
  (``main_cfar.m:85-96``): the JAX device path, and the port's on the card,
  where a window's work after the join is replayed as one CUDA graph
  (:class:`_WindowGraph`; its first window and its capture run on a side
  stream, ordered against the consumer's by stream waits);
* the block path (the JAX package's CPU path, and the port's on the CPU)
  gathers K+1 consecutive frames and runs them through
  ``models.host_parallel.make_stream_pipeline``: each frame compressed
  once, one B2 and one B1 launch over the block's K windows, the last
  frame's compressed form carried into the next block.

With ``mesh`` (the JAX ``models/streaming.py:98-174`` branch) every rank of
the mesh runs the pipeline over the same capture: beams over ``dp`` (padded
to it), slow time then range over ``sp``, the compressed previous frame
carried between windows (``parallel.make_sharded_stream``), and the stacks
gathered on the mesh's first rank, which extracts the detections.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import RadarProfile, range_concat
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.models.detect import RENOTCH_DIVISOR, Detector, clutter_cells
from radar_signal_process_tpu_torch.models.host_parallel import EMIT_MODES, make_stream_pipeline
from radar_signal_process_tpu_torch.models.mtd_pipeline import FrameProcessor
from radar_signal_process_tpu_torch.ops.dbf import apply_dbf
from radar_signal_process_tpu_torch.ops.measure import extract_detections
from radar_signal_process_tpu_torch.parallel.mesh import axis_size
from radar_signal_process_tpu_torch.parallel.sharding import (
    gather_blocks,
    local_block,
    make_sharded_stream,
)
from radar_signal_process_tpu_torch.params import chain_params
from radar_signal_process_tpu_torch.utils import Counters
from radar_signal_process_tpu_torch.utils.profiling import span


class StreamResult(NamedTuple):
    frame_idx: int
    rdms: object        # (n_beams, win_size, n_prt, n_points) tensor, or None
    flags: object       # same-shape bool tensor, or None (reduced emit modes)
    detections: object  # DetectionList batched over (n_beams, win_size)
    cfar_hits: int = 0  # total cascade flags across the window


class BeamFrame(NamedTuple):
    """A frame read as its beams, each (prt, samples): staged side by side,
    with no DBF; ``frame_completed`` False past the end of the capture."""

    beams: tuple
    frame_completed: bool = True


class TwoBeamReader:
    """A G1-format reader (``ingest.g1_reader_class``: frames counted from
    1, ``read_frame -> (left, right, angles, meta)``) as a stream's reader:
    frames counted from 0, each a :class:`BeamFrame` of its two beams, and
    an incomplete one past the end of the capture, where the reader raises
    on the missing file or the short read (``cli ingest`` ends a G1 capture
    there too)."""

    def __init__(self, reader):
        self.reader = reader

    def read_frame(self, idx: int) -> BeamFrame:
        try:
            left, right, _, _ = self.reader.read_frame(idx + 1)
        except (OSError, EOFError):
            return BeamFrame((), False)
        return BeamFrame((left, right))


class _WindowGraph:
    """The windowed path's device work on a card, replayed as one CUDA graph.

    A window's two staged frames are joined into a static window (the frame
    processor's ``torch.cat``); the graph runs the frame processor and the
    detector on it and counts the window's flags.  The first window runs
    eagerly on the capture stream, which builds what the capture must find
    made (cuFFT plans, the kernels, B1's launch plans); the second captures
    the graph; from then on a window replays it.  Kernel wrappers count
    their launches when called, so once per capture on this path.  A
    replayed window returns copies of the stacks that ``emit`` keeps, and of
    its detection list, which no later window writes.
    """

    def __init__(self, processor: FrameProcessor, detector: Detector, emit: str):
        self.processor, self.detector = processor, detector
        self.keep_rdms, self.keep_flags = emit == "full", emit != "detections"
        self.window: Optional[torch.Tensor] = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[tuple] = None

    def _work(self) -> tuple:
        rdms = self.processor.produce(self.window)
        flags, _, dets = self.detector(rdms)
        return rdms, flags, dets, flags.sum()

    def __call__(self, prev: torch.Tensor, cur: torch.Tensor) -> tuple:
        """``(rdms, flags, dets, hits)`` of the window ``(prev, cur)``; the
        stacks None where ``emit`` drops them."""
        if self.graph is None and self.out is None:
            return self._first(prev, cur)
        if self.graph is None:
            torch.cat([prev, cur], dim=-2, out=self.window)
            with span("stream.capture", "launch"):
                self.graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(self.graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    self.out = self._work()
            with span("stream.replay", "launch"):
                copies = self._replay()
        else:
            with span("stream.replay", "launch"):
                torch.cat([prev, cur], dim=-2, out=self.window)
                copies = self._replay()
        return (*copies, int(self.out[3]))

    def _replay(self) -> tuple:
        """Replay the graph; copies of its stacks that ``emit`` keeps and of
        its detection list, which no later replay writes."""
        self.graph.replay()
        rdms, flags, dets, _ = self.out
        return (rdms.clone() if self.keep_rdms else None,
                flags.clone() if self.keep_flags else None,
                type(dets)(*(t.clone() for t in dets)))

    def _first(self, prev: torch.Tensor, cur: torch.Tensor) -> tuple:
        """The first window, eagerly on the capture stream."""
        self.window = torch.empty(prev.shape[:-2] + (2 * prev.shape[-2], prev.shape[-1]),
                                  dtype=prev.dtype, device=prev.device)
        self.stream = torch.cuda.Stream(prev.device)
        torch.cat([prev, cur], dim=-2, out=self.window)
        main = torch.cuda.current_stream(prev.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.out = rdms, flags, dets, hits = self._work()
        main.wait_stream(self.stream)
        for t in (rdms, flags, hits, *dets):
            t.record_stream(main)       # the caller reads and frees them on ``main``
        return (rdms if self.keep_rdms else None, flags if self.keep_flags else None, dets,
                int(hits))


class StreamingPipeline:
    """Iterate detection results over a continuous capture.

    ``reader`` is any object with ``read_frame(idx) -> FrameResult``
    (``radar_signal_process_tpu_torch.ingest.G2FrameReader`` or
    ``NativeG2FrameReader``), or a :class:`TwoBeamReader` over a G1-format
    reader, whose :class:`BeamFrame` frames are their two beams (no DBF).
    A profile with a ``config.range_concat`` table (G1) has its compressed
    columns re-concatenated before the windows are sliced.  ``emit`` selects
    what each :class:`StreamResult` carries: ``"full"`` (RDM + flag stacks),
    ``"flags"`` (no RDMs) or ``"detections"`` (neither).  ``device`` is
    where the chain runs; a CUDA device that is absent raises.
    ``stc_curve_db`` (used when ``profile.mtd.istc`` is set) and ``pulses``
    (measured matched-filter waveforms) are the stage-2 hooks of
    :func:`models.mtd_pipeline.make_frame_processor`.

    ``mesh`` (a ``DeviceMesh`` with axes ``("dp", "sp")`` on ``device``'s
    type, ``parallel.make_mesh``) runs the sharded stream on every rank of
    the mesh; its first rank yields the gathered stacks and the detections,
    the other ranks the window index with ``None`` in their place.

    ``use_host_parallel`` selects the block path (module docstring); None
    means on a CPU ``device``, the JAX rule "on the CPU backend".  A block is
    ``block_windows`` windows; a frame that does not follow the last one
    closes the block (its windows still run) and starts the next.  The
    producer queue holds 2 frames on the windowed path and K+1 on the block
    path, K being ``block_windows``.  At G2 a pinned frame is 332 x 3404 x 16
    complex64 = 145 MB; the queue's K+1 frames and the up to K of the block
    under assembly make 2K+1, ~1.9 GB of pinned host memory at K = 6.  In a
    block the stacks of ``emit="full"`` are views of the block's tensors.
    """

    def __init__(
        self,
        reader,
        profile: RadarProfile,
        win_size: int = 4,
        max_frames: int = 10_000,
        clutter_v: float = 3.0,
        max_detections: int = 64,
        dbf_coeffs: np.ndarray | None = None,
        emit: str = "full",
        device: str | torch.device = "cuda",
        stc_curve_db: np.ndarray | None = None,
        pulses=None,
        mesh=None,
        use_host_parallel: bool | None = None,
        block_windows: int = 6,
    ):
        if emit not in EMIT_MODES:
            raise ValueError(f"emit must be one of {EMIT_MODES}, got {emit!r}")
        if block_windows < 1:
            raise ValueError(f"block_windows must be >= 1, got {block_windows}")
        self.device = resolve_device(device)
        self.reader = reader
        self.profile = profile
        self.max_frames = max_frames
        self.counters = Counters()
        self._emit = emit
        params = chain_params(profile, dbf_coeffs=dbf_coeffs, pulses=pulses,
                              stc_curve_db=stc_curve_db, device=self.device)
        self._dbf = params.dbf
        n_clutter = clutter_cells(profile, profile.prt_per_frame, clutter_v)
        concat = range_concat(profile)
        self._mesh = mesh
        if use_host_parallel is None:
            use_host_parallel = self.device.type == "cpu"
        self._block_runner = None
        queue_depth = 2       # the windowed producer stays a frame ahead
        if mesh is not None:
            if concat:
                raise ValueError(f"the mesh stream has no range re-concatenation "
                                 f"(profile {profile.name})")
            self._init_mesh(mesh, n_clutter, win_size, max_detections, stc_curve_db, pulses)
        elif use_host_parallel:
            self._block_runner = make_stream_pipeline(
                profile, win_size, n_clutter, max_detections=max_detections,
                stc_curve_db=stc_curve_db, pulses=pulses, emit=emit, device=self.device,
                concat=concat,
            )
            self._block_windows = block_windows
            # the producer stays a block ahead: the next block's frames are
            # parsed while the current one runs
            queue_depth = block_windows + 1
        else:
            self._processor = FrameProcessor(profile, params, win_size, concat)
            self._detector = Detector(profile, n_clutter, max_detections, device=self.device)
            self._graph = (_WindowGraph(self._processor, self._detector, emit)
                           if self.device.type == "cuda" else None)
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=queue_depth)
        self._thread: Optional[threading.Thread] = None
        self._producer_error: Optional[BaseException] = None

    def _init_mesh(self, mesh, n_clutter, win_size, max_detections, stc_curve_db, pulses):
        if mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, stream on {self.device}")
        # Parity floor (ROADMAP C3): below a cropped velocity extent of
        # 2*(ref+guard)+1 cells some cells have both reference windows out
        # of range, and the roll-form and padded-form edge fallbacks read
        # different data, so this stream's hits may differ from the JAX
        # package's mesh and single-device streams; real profiles (G2: 303
        # used rows) are far above it
        nvu = self.profile.prt_per_frame - 2 * n_clutter - 1
        span = 2 * (self.profile.cfar.ref_cells + self.profile.cfar.guard_cells)
        if nvu <= span:
            logging.getLogger("radar_tpu_torch.streaming").warning(
                "mesh stream: cropped velocity extent %d <= 2*(ref+guard)=%d -- below the "
                "CFAR cross-implementation parity floor; hit counts may differ from the "
                "JAX package's at window edges (ops/cfar.py)", nvu, span,
            )
        self._compress, self._step = make_sharded_stream(
            self.profile, mesh, n_clutter=n_clutter, win_size=win_size,
            renotch_divisor=RENOTCH_DIVISOR, stc_curve_db=stc_curve_db, pulses=pulses,
        )
        self._max_detections = max_detections
        self._carry: dict = {}       # {frame index: its compressed block}
        self._n_beams = 0

    # ------------------------------------------------------------- producer
    def _produce(self) -> None:
        try:
            self._produce_inner()
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            # a reader failure must not masquerade as clean end-of-data
            self._producer_error = e
        finally:
            self._queue.put(None)

    def _produce_inner(self) -> None:
        for idx in range(self.max_frames):
            res = self.reader.read_frame(idx)
            if not res.frame_completed:
                break
            with span("stream.pin", "pin") as s:
                host = self._pin(res)
                s.nbytes = host.numel() * host.element_size()
            t0 = time.perf_counter()
            self._queue.put((idx, host))
            # time the producer spent blocked on a full queue (compute is
            # the bottleneck — the healthy steady state)
            self.counters.add("producer_wait_s", time.perf_counter() - t0)
            self.counters.add("frames_ingested")
            self.counters.add("prts_parsed", self.profile.prt_per_frame)

    def _pin(self, res) -> torch.Tensor:
        """A frame as (prt, samples, channels) in host memory of its own
        (a reader may reuse its buffers), pinned so that the device copy is
        asynchronous.  A G1 frame's beams are written into one (beams, prt,
        samples) block, returned as that view: the device copy then takes
        the block whole, and the consumer's permute gives it back
        contiguous."""
        pin = self.device.type == "cuda"
        if not isinstance(res, BeamFrame):
            host = torch.from_numpy(np.asarray(res.iq, dtype=np.complex64))
            return host.pin_memory() if pin else host.clone()
        host = torch.empty((len(res.beams),) + res.beams[0].shape, dtype=torch.complex64,
                           pin_memory=pin)
        for dst, beam in zip(host, res.beams):
            dst.copy_(torch.from_numpy(beam))
        return host.permute(1, 2, 0)

    # ------------------------------------------------------------- consumer
    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        """(prt, samples, channels) host frame -> (beams, prt, samples) on
        device; with a mesh, this rank's block: its sp rows (cut before the
        copy), then its dp beams of the beams padded to the dp extent."""
        if self._mesh is not None:
            host = local_block(host, self._mesh, ("sp",))
        with span("stream.h2d", "copy", host.numel() * host.element_size()):
            frame = host.to(self.device, non_blocking=True)
        with span("stream.dbf", "launch"):
            if self._dbf is not None:
                frame = apply_dbf(frame, self._dbf)
            frame = frame.permute(2, 0, 1)
            if self._mesh is None:
                return frame.contiguous()
        self._n_beams = frame.shape[0]
        pad = (-frame.shape[0]) % axis_size(self._mesh, "dp")
        if pad:
            frame = torch.cat([frame, frame.new_zeros((pad,) + frame.shape[1:])])
        return local_block(frame, self._mesh, ("dp",)).contiguous()

    @torch.inference_mode()
    def _process(self, prev: torch.Tensor, cur: torch.Tensor, prev_idx: int):
        """``(rdms, flags, dets, hits)`` of the window ``(prev, cur)``,
        ``hits`` the count of its cascade flags."""
        if self._mesh is None:
            if self._graph is not None:
                return self._graph(prev, cur)
            rdms = self._processor(prev, cur)
            flags, _, dets = self._detector(rdms)
            return rdms, flags, dets, int(flags.sum())
        # consecutive frames reuse the carried compressed frame; anything
        # else (a stream restart) compresses the window's first frame anew
        pc = self._carry.pop(prev_idx, None)
        if pc is None:
            pc = self._compress(prev)
        pc_next, rdms, flags, _ = self._step(pc, cur)
        self._carry = {prev_idx + 1: pc_next}
        spec = ("dp", None, None, "sp")
        rdms, flags = gather_blocks(rdms, self._mesh, spec), gather_blocks(flags, self._mesh, spec)
        if rdms is None:             # not the mesh's first rank
            return None, None, None, 0
        rdms, flags = rdms[: self._n_beams], flags[: self._n_beams]
        return (rdms, flags, extract_detections(flags, rdms, self._max_detections),
                int(flags.sum()))

    def __iter__(self) -> Iterator[StreamResult]:
        if self._block_runner is not None:
            return self._iter_pipelined()
        return self._iter_windowed()

    @torch.inference_mode()
    def _iter_pipelined(self) -> Iterator[StreamResult]:
        """Block consumer: gather K+1 consecutive frames, run them as one
        block, yield its windows in order, carry the last frame and its
        compressed form into the next block."""
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        k = self._block_windows
        carry = None        # (idx, staged frame, its compressed form or None)
        eos = False
        while not eos:
            block, base_idx, pc = [], None, None
            if carry is not None:
                base_idx, first, pc = carry
                block.append(first)
            carry = None
            while len(block) < k + 1:
                t0 = time.perf_counter()
                item = self._queue.get()
                self.counters.add("consumer_wait_s", time.perf_counter() - t0)
                if item is None:
                    eos = True
                    break
                idx, host = item
                if base_idx is None:
                    base_idx = idx
                elif idx != base_idx + len(block):
                    # a gap closes the block (its windows still run), as the
                    # windowed iterator skips it; the next block starts here
                    carry = (idx, self._stage(host), None)
                    break
                # frames[0] is staged now, the others when the block
                # compresses them: each host frame is released once staged
                block.append(host if block else self._stage(host))
            if len(block) < 2:
                continue
            n_windows = len(block) - 1
            slots = dict(enumerate(block))
            staged_last: list = []

            def stage(i):
                frame = self._stage(slots.pop(i))
                if i == n_windows:
                    staged_last.append(frame)
                return frame

            frames = [slots.pop(0)] + [(lambda i=i: stage(i)) for i in range(1, len(block))]
            del block
            results: list = []
            last = self._block_runner(frames, lambda *r: results.append(r), carry=pc)
            del frames
            if carry is None:
                carry = (base_idx + n_windows, staged_last[0], last)
            for w, rdms, flags, dets, hits in results:
                self.counters.add("windows_processed")
                self.counters.add("cfar_hits", hits)
                yield StreamResult(base_idx + w, rdms, flags, dets, hits)
            del results
        self._thread.join()
        if self._producer_error is not None:
            raise self._producer_error

    def _iter_windowed(self) -> Iterator[StreamResult]:
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()
        prev = None
        prev_idx = -1
        while True:
            t0 = time.perf_counter()
            item = self._queue.get()
            # time compute spent starved waiting for ingest
            self.counters.add("consumer_wait_s", time.perf_counter() - t0)
            if item is None:
                break
            idx, host = item
            dev = self._stage(host)
            if prev is not None and idx == prev_idx + 1:
                rdms, flags, dets, hits = self._process(prev, dev, prev_idx)
                self.counters.add("windows_processed")
                self.counters.add("cfar_hits", hits)
                if self._emit == "detections":
                    rdms = flags = None
                elif self._emit == "flags":
                    rdms = None
                yield StreamResult(prev_idx, rdms, flags, dets, hits)
            prev, prev_idx = dev, idx
        self._thread.join()
        if self._producer_error is not None:
            raise self._producer_error

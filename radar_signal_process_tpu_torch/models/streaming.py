"""Streaming execution: overlapped host ingest + device compute.

Port of the device branch of ``radar_signal_process_tpu/models/streaming.py``
(the windowed consumer).  A background thread parses ``.bin`` frames and
stages each into pinned host memory while the device processes the previous
window.  The consumer copies the frame to the device on the current
stream, beamforms it there when DBF coefficients are given, pairs it with the
previous frame into a doubled-CPI window
(``main_produce_dataset_win_xzr_v2.m:75-103``) and runs the frame processor
and the detector over every (beam, slice) RDM (``main_cfar.m:85-96``).
All device work is issued on one stream, so no cross-stream events are
needed; the pinned copy makes the host-to-device transfer asynchronous.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.models.detect import Detector, clutter_cells
from radar_signal_process_tpu_torch.models.mtd_pipeline import FrameProcessor
from radar_signal_process_tpu_torch.ops.dbf import apply_dbf
from radar_signal_process_tpu_torch.params import chain_params
from radar_signal_process_tpu_torch.utils import Counters

EMIT_MODES = ("full", "flags", "detections")


class StreamResult(NamedTuple):
    frame_idx: int
    rdms: object        # (n_beams, win_size, n_prt, n_points) tensor, or None
    flags: object       # same-shape bool tensor, or None (reduced emit modes)
    detections: object  # DetectionList batched over (n_beams, win_size)
    cfar_hits: int = 0  # total cascade flags across the window


class StreamingPipeline:
    """Iterate detection results over a continuous capture.

    ``reader`` is any object with ``read_frame(idx) -> FrameResult``
    (``radar_signal_process_tpu_torch.ingest.G2FrameReader`` or
    ``NativeG2FrameReader``).  ``emit`` selects what each
    :class:`StreamResult` carries: ``"full"`` (RDM + flag stacks),
    ``"flags"`` (no RDMs) or ``"detections"`` (neither).  ``device`` is
    where the chain runs; a CUDA device that is absent raises.
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
    ):
        if emit not in EMIT_MODES:
            raise ValueError(f"emit must be one of {EMIT_MODES}, got {emit!r}")
        self.device = resolve_device(device)
        self.reader = reader
        self.profile = profile
        self.max_frames = max_frames
        self.counters = Counters()
        self._emit = emit
        params = chain_params(profile, dbf_coeffs=dbf_coeffs, device=self.device)
        self._dbf = params.dbf
        self._processor = FrameProcessor(profile, params, win_size)
        self._detector = Detector(
            profile, clutter_cells(profile, profile.prt_per_frame, clutter_v),
            max_detections, device=self.device,
        )
        # two parsed frames in flight: the producer stays one frame ahead
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=2)
        self._thread: Optional[threading.Thread] = None
        self._producer_error: Optional[BaseException] = None

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
            # (prt, samples, channels); a copy, since a reader may reuse its
            # buffer, and pinned so the device copy is asynchronous
            host = torch.from_numpy(np.asarray(res.iq, dtype=np.complex64))
            host = host.pin_memory() if self.device.type == "cuda" else host.clone()
            t0 = time.perf_counter()
            self._queue.put((idx, host))
            # time the producer spent blocked on a full queue (compute is
            # the bottleneck — the healthy steady state)
            self.counters.add("producer_wait_s", time.perf_counter() - t0)
            self.counters.add("frames_ingested")
            self.counters.add("prts_parsed", self.profile.prt_per_frame)

    # ------------------------------------------------------------- consumer
    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        """(prt, samples, channels) host frame -> (beams, prt, samples) on device."""
        frame = host.to(self.device, non_blocking=True)
        if self._dbf is not None:
            frame = apply_dbf(frame, self._dbf)
        return frame.permute(2, 0, 1).contiguous()

    @torch.inference_mode()
    def _process(self, prev: torch.Tensor, cur: torch.Tensor):
        rdms = self._processor(prev, cur)
        flags, _, dets = self._detector(rdms)
        return rdms, flags, dets

    def __iter__(self) -> Iterator[StreamResult]:
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
                rdms, flags, dets = self._process(prev, dev)
                hits = int(flags.sum())
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

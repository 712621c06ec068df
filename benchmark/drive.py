"""The traffic side of a run, the same for every system: the source that
hands frames over by the traffic file's arrival process, and the measured
window that drives a system's results and keeps what the check needs.

Arrival processes (``traffic["arrival"]["kind"]``):

- ``closed``: the next frame is handed over as soon as the program asks for
  it; a frame's latency runs from the moment it was handed over.
- ``periodic``: from the window's start, frame ``k`` is due ``k`` periods
  later (``period_s``, or the configuration's ``frame_period_s``) and is not
  handed over before; its latency runs from its due time, so a program that
  falls behind pays for the wait.
"""

from __future__ import annotations

import importlib
import threading
import time

import torch

from benchmark.frames import host_rng


def distinct_frames(traffic: dict, frame_bytes: int) -> int:
    """As many distinct frames as ``distinct_bytes`` holds, 2 to ``max_distinct``."""
    return max(2, min(traffic["max_distinct"], traffic["distinct_bytes"] // frame_bytes))


class Source:
    """``read(idx)``: frame ``idx`` from the store, by the arrival process;
    None once stopped.  ``handed[idx]`` is each frame's latency origin."""

    def __init__(self, traffic: dict, config: dict, spans):
        arrival = traffic["arrival"]
        if arrival["kind"] not in ("closed", "periodic"):
            raise ValueError(f"unknown arrival process {arrival['kind']!r}")
        self.periodic = arrival["kind"] == "periodic"
        self.period = arrival.get("period_s") or config.get("frame_period_s")
        self.spans = spans
        self.store = None
        self.stopped = threading.Event()
        self.handed: dict = {}
        self.t_open = self.first = None

    def open_store(self, name: str, sut) -> None:
        self.store = importlib.import_module(f"benchmark.stores.{name}").Store(sut)

    def open(self, t0: float) -> None:
        """The window starts: due times count from ``t0``."""
        self.t_open = t0

    def read(self, idx: int):
        if self.stopped.is_set():
            return None
        due = None
        if self.periodic and self.t_open is not None:
            if self.first is None:
                self.first = idx
            due = self.t_open + (idx - self.first) * self.period
            wait = due - time.perf_counter()
            if wait > 0 and self.stopped.wait(wait):
                return None
        with self.spans("read_frame"):
            frame = self.store.get(idx)
        self.handed[idx] = due if due is not None else time.perf_counter()
        return frame


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` on the host, queued on the current stream into pinned
    memory (read only after the device has synchronised), so that keeping a
    result neither blocks the host nor holds the card's memory."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def warm_up(sut, results, n: int) -> None:
    """``n`` results through the system's own path.  The last ``sut.n`` are
    kept at once, as the window keeps one of each distinct frame, so that
    the pinned blocks the window's copies take are allocated here and
    cached; then none is held."""
    held = []
    for i in range(n):
        _, _, res, _ = next(results)
        if i >= n - sut.n:
            held.append(sut.snapshot(res))
        del res
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    del held


def window(sut, results, source: Source, traffic: dict, seed: int, t0: float, seconds: float,
           trace) -> tuple:
    """Drive the system's ``results`` for ``seconds`` from ``t0``; then stop the
    source and take the results already handed over.  Returns the records
    ``(frame, latency origin, done or None)`` of the window, the kept
    results and every pulled one.

    Kept: for each distinct frame ``key``, its ``p``-th occurrence in the
    window, ``p`` drawn from the seed below ``keep_among``, copied to the
    host by the system (``to_host``: the card holds only the program's
    state), and what the store keeps of that handover."""
    n = sut.n
    rng = host_rng(seed, 4)
    pick = rng.integers(traffic["keep_among"], size=n)
    seen = [0] * n
    kept, pulled, done = {}, {}, {}
    t_end = t0 + seconds
    source.open(t0)
    trace.begin()
    for frame, t, res, out in results:
        trace.count(t)
        done[frame] = t
        if t > t_end:
            break
        key = frame % n
        if seen[key] == pick[key]:
            kept[key] = (frame, sut.snapshot(res), source.store.take(frame))
        seen[key] += 1
        pulled[frame] = out
        del res
    source.stopped.set()
    for frame, t, _, _ in results:      # drain: the frames already handed over
        done[frame] = t
    handed = source.handed
    records = [(f, handed[f], done.get(f)) for f in sorted(handed)
               if handed[f] >= t0 or done.get(f, t0) > t0]
    return records, kept, pulled

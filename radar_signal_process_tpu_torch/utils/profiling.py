"""Per-stage wall-clock timers, and the spans of the port's hot paths.

:class:`StageTimers` is the port's counterpart of the JAX package's
``utils/profiling.py``: the reference's tic/toc per stage
(``DMX_SignalProcessing_main_xzr.m:337-496``), with a fence on the card in
place of JAX's ``block_until_ready``.

:func:`span` marks a leaf step of a hot path on the host's clock,
``time.perf_counter``, with no fence: the host's time to copy, pin or launch
the step's work.  A span records only while a ``torch.profiler`` session
runs; otherwise it costs one check.  It touches nothing on the card: it
calls nothing in ``torch.cuda`` and allocates no tensor.  Records go to one
store for the whole process, from any thread; :func:`spans` reads it and
:func:`clear` empties it.  A profiler's device trace lays its kernels on the
same clock, so a span can be set against the device's busy and idle time.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple

import torch
import torch.autograd.profiler as _profiler

KINDS = ("launch", "copy", "pin")
CAPACITY = 1 << 20        # records kept; later ones are counted as dropped

_records: List[tuple] = []     # Span fields, as plain tuples: cheaper to make
_dropped = 0
_lock = threading.Lock()


class Span(NamedTuple):
    """One span: its name and kind, start and end on ``time.perf_counter``,
    the thread (``threading.get_ident``) and the bytes it copied or pinned."""

    name: str
    kind: str
    t0: float
    t1: float
    thread: int
    nbytes: int


class _Off:
    """The span of a process with no profiler session: records nothing;
    ``nbytes`` set on it is dropped."""

    __slots__ = ()
    nbytes = property(lambda self: 0, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "kind", "nbytes", "t0")

    def __init__(self, name: str, kind: str, nbytes: int):
        self.name, self.kind, self.nbytes = name, kind, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        global _dropped
        rec = (self.name, self.kind, self.t0, time.perf_counter(), threading.get_ident(),
               self.nbytes)
        with _lock:
            if len(_records) < CAPACITY:
                _records.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, kind: str, nbytes: int = 0):
    """A context manager around one leaf step: ``kind`` is ``"launch"``
    (work enqueued on the device), ``"copy"`` (a copy onto it, of ``nbytes``)
    or ``"pin"`` (a copy into pinned host memory, of ``nbytes``; the
    ``nbytes`` of the object it yields may be set inside the step)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if kind not in KINDS:
        raise ValueError(f"span kind must be one of {KINDS}, got {kind!r}")
    return _On(name, kind, nbytes)


def spans() -> List[Span]:
    """The records kept so far, in the order they ended."""
    with _lock:
        return [Span(*r) for r in _records]


def dropped() -> int:
    """The records let go past :data:`CAPACITY`."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped records."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


class StageTimers:
    """Host wall-clock time per named stage.

    Work on the card is asynchronous, so on a CUDA ``device`` every stage
    ends in ``torch.cuda.synchronize`` before its time is read: a stage's
    time then holds the device work it enqueued.  A stage that raises is
    not recorded.  Each stage is also a ``"launch"`` :func:`span` of its
    name, fence included.
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        with span(name, "launch"):
            t0 = time.perf_counter()
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v),
                   "min_s": min(v)}
            for name, v in self.records.items()
        }

    def report(self) -> str:
        return "\n".join(
            f"{name:<22} n={s['count']:<4} mean={s['mean_s']*1e3:8.2f} ms  "
            f"min={s['min_s']*1e3:8.2f} ms  total={s['total_s']:7.3f} s"
            for name, s in self.summary().items()
        )

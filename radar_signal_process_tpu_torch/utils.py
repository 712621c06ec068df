"""Pipeline counters and per-stage wall-clock timers.

The port's own copies of ``Counters`` (the JAX package's
``utils/logging.py``: an explicit counter object in place of the
reference's per-layer ``fprintf`` progress lines, SURVEY.md §5.5) and
``StageTimers`` (``utils/profiling.py``: the reference's tic/toc per stage,
``DMX_SignalProcessing_main_xzr.m:337-496``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List

import torch


class Counters:
    """Monotonic named counters with snapshot/delta reporting."""

    def __init__(self):
        self._c: Dict[str, float] = collections.defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        self._c[name] += value

    def get(self, name: str) -> float:
        return self._c[name]

    def snapshot(self) -> Dict[str, float]:
        return dict(self._c)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v:g}" for k, v in sorted(self._c.items()))
        return f"Counters({inner})"


class StageTimers:
    """Host wall-clock time per named stage.

    Work on the card is asynchronous, so on a CUDA ``device`` every stage
    ends in ``torch.cuda.synchronize`` before its time is read: a stage's
    time then holds the device work it enqueued.
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
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

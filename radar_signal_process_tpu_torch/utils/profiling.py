"""Per-stage wall-clock timers.

The port's counterpart of the JAX package's ``utils/profiling.py``: the
reference's tic/toc per stage (``DMX_SignalProcessing_main_xzr.m:337-496``),
with a fence on the card in place of JAX's ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


class StageTimers:
    """Host wall-clock time per named stage.

    Work on the card is asynchronous, so on a CUDA ``device`` every stage
    ends in ``torch.cuda.synchronize`` before its time is read: a stage's
    time then holds the device work it enqueued.  A stage that raises is
    not recorded.
    """

    def __init__(self, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
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

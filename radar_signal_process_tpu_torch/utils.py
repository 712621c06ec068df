"""Pipeline counters (frames ingested, PRTs parsed, waits, CFAR hits).

The port's own copy of ``Counters`` from the JAX package's
``utils/logging.py``: an explicit counter object in place of the
reference's per-layer ``fprintf`` progress lines (SURVEY.md §5.5).
"""

from __future__ import annotations

import collections
from typing import Dict


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

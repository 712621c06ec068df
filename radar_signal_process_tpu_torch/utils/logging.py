"""Structured logging + pipeline counters.

Replaces the reference's per-layer ``fprintf`` progress lines and 15+
``warning()`` sites (SURVEY.md §5.5) with standard logging plus an explicit
counter object (frames ingested, PRTs parsed, retries, CFAR hits per frame).

The port's own copy of the JAX package's ``utils/logging.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

import collections
import logging
from typing import Dict


def get_logger(name: str = "radar_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


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

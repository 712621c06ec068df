"""Detection-quality metrics, replicated from the reference's local functions.

The port's own copy of the JAX package's ``evalx/metrics.py`` (numpy only).

``main_cfar.m`` defines (but never invokes from the live loop) four metrics
against per-frame truth tracks: per-frame false-alarm rate (:163-175),
detection rate (:177-206), combined accuracy (:208-234), and a
localization-quality score "PCF" from the RDM-peak offset (:236-279).
The truth gate is 3 < |V| < 20 m/s and 400 < R < 2000 m (:165,186).

These are host-side NumPy (the detection lists are tiny); ``evaluate_frames``
is the batch entry point the reference lacks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TruthGate:
    """Validity gate on the truth track (``main_cfar.m:165``)."""

    v_min: float = 3.0
    v_max: float = 20.0
    r_min: float = 400.0
    r_max: float = 2000.0
    # truth window half-sizes in cells (V +-3, R +-7; :167)
    v_half: int = 3
    r_half: int = 7

    def active(self, r_true: float, v_true: float) -> bool:
        return (
            self.v_min < abs(v_true) < self.v_max
            and self.r_min < r_true < self.r_max
        )


def _truth_indices(r_axis, v_axis, r_true, v_true):
    r_idx = int(np.argmin(np.abs(np.asarray(r_axis) - r_true)))
    v_idx = int(np.argmin(np.abs(np.asarray(v_axis) - v_true)))
    return r_idx, v_idx


def false_alarm_rate(
    flags: np.ndarray,
    r_true: float,
    v_true: float,
    r_axis: np.ndarray,
    v_axis: np.ndarray,
    gate: TruthGate = TruthGate(),
) -> float:
    """Per-frame FA rate excluding the truth window (``fun_frame_fa``)."""
    flags = np.asarray(flags, dtype=bool)
    m, n = flags.shape
    if gate.active(r_true, v_true):
        r_idx, v_idx = _truth_indices(r_axis, v_axis, r_true, v_true)
        work = flags.copy()
        work[
            max(v_idx - gate.v_half, 0) : v_idx + gate.v_half + 1,
            max(r_idx - gate.r_half, 0) : r_idx + gate.r_half + 1,
        ] = False
        n_fa = int(work.sum())
    else:
        n_fa = int(flags.sum())
    return n_fa / (m * n)


def detection_rate(
    flags_per_frame: Sequence[np.ndarray],
    r_true: Sequence[float],
    v_true: Sequence[float],
    r_axis: np.ndarray,
    v_axis: np.ndarray,
    gate: TruthGate = TruthGate(),
) -> float:
    """Fraction of gated frames with a hit in the truth window (``fun_drate``)."""
    n_hit = n_miss = 0
    for flags, rt, vt in zip(flags_per_frame, r_true, v_true):
        if not gate.active(rt, vt):
            continue
        r_idx, v_idx = _truth_indices(r_axis, v_axis, rt, vt)
        window = np.asarray(flags, dtype=bool)[
            max(v_idx - gate.v_half, 0) : v_idx + gate.v_half + 1,
            max(r_idx - gate.r_half, 0) : r_idx + gate.r_half + 1,
        ]
        if window.any():
            n_hit += 1
        else:
            n_miss += 1
    return n_hit / (n_hit + n_miss) if (n_hit + n_miss) else float("nan")


def accuracy(
    flags_per_frame: Sequence[np.ndarray],
    r_true: Sequence[float],
    v_true: Sequence[float],
    r_axis: np.ndarray,
    v_axis: np.ndarray,
    gate: TruthGate = TruthGate(),
) -> float:
    """Combined accuracy over all frames (``fun_accuracy``).

    Gated frames count when the truth window holds a hit; ungated frames
    count when *any* hit exists — replicated as written (:217-228).
    """
    n_correct = 0
    total = 0
    for flags, rt, vt in zip(flags_per_frame, r_true, v_true):
        total += 1
        flags = np.asarray(flags, dtype=bool)
        if gate.active(rt, vt):
            r_idx, v_idx = _truth_indices(r_axis, v_axis, rt, vt)
            window = flags[
                max(v_idx - gate.v_half, 0) : v_idx + gate.v_half + 1,
                max(r_idx - gate.r_half, 0) : r_idx + gate.r_half + 1,
            ]
            if window.any():
                n_correct += 1
        else:
            if flags.any():
                n_correct += 1
    return n_correct / total if total else float("nan")


def localization_pcf(
    flags_per_frame: Sequence[np.ndarray],
    rdm_per_frame: Sequence[np.ndarray],
    r_true: Sequence[float],
    v_true: Sequence[float],
    r_axis: np.ndarray,
    v_axis: np.ndarray,
    gate: TruthGate = TruthGate(),
    n_cell: int = 20,
    dv_base: float = 1.0 / 0.2719,
    dr_base: float = 30.0 / 6.0,
) -> float:
    """Localization-quality score from the RDM peak offset (``fun_PCF``).

    For each gated frame with a hit in the +-``n_cell`` neighborhood, the
    local RDM maximum's cell offset (dv, dr) from truth scores
    ``1 - l/l_base`` inside the base ellipse, decaying exponentially outside.
    """
    scores = []
    l_base = dv_base**2 + dr_base**2
    for flags, rdm, rt, vt in zip(flags_per_frame, rdm_per_frame, r_true, v_true):
        if not gate.active(rt, vt):
            continue
        flags = np.asarray(flags, dtype=bool)
        rdm = np.asarray(rdm)
        nv, nr = rdm.shape
        r_idx, v_idx = _truth_indices(r_axis, v_axis, rt, vt)
        v_range = slice(max(v_idx - n_cell, 0), min(v_idx + n_cell + 1, nv))
        r_range = slice(max(r_idx - n_cell, 0), min(r_idx + n_cell + 1, nr))
        if not flags[v_range, r_range].any():
            continue
        local_max = rdm[v_range, r_range].max()
        v_ind, r_ind = np.nonzero(rdm == local_max)
        dv = abs(v_idx - v_ind[0])
        dr = abs(r_idx - r_ind[0])
        loc = dv**2 + dr**2
        if loc < l_base:
            scores.append(1.0 - loc / l_base)
        else:
            scores.append(np.exp(1.0 - loc / l_base) - 1.0)
    return float(np.mean(scores)) if scores else float("nan")


def evaluate_frames(
    flags_per_frame: Sequence[np.ndarray],
    rdm_per_frame: Sequence[np.ndarray],
    r_true: Sequence[float],
    v_true: Sequence[float],
    r_axis: np.ndarray,
    v_axis: np.ndarray,
    gate: TruthGate = TruthGate(),
) -> dict:
    """All four reference metrics over a frame batch."""
    fas = [
        false_alarm_rate(f, rt, vt, r_axis, v_axis, gate)
        for f, rt, vt in zip(flags_per_frame, r_true, v_true)
    ]
    return {
        "false_alarm_rate": float(np.mean(fas)),
        "detection_rate": detection_rate(
            flags_per_frame, r_true, v_true, r_axis, v_axis, gate
        ),
        "accuracy": accuracy(flags_per_frame, r_true, v_true, r_axis, v_axis, gate),
        "localization_pcf": localization_pcf(
            flags_per_frame, rdm_per_frame, r_true, v_true, r_axis, v_axis, gate
        ),
    }

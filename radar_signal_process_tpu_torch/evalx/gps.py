"""Differential-GPS ground-truth comparison (reference S6).

The reference overlays a differential-GPS track on the radar estimates
(``DMX_SignalProcessing_main_xzr.m:567-601``) but its parser
(``GPSDataReadParse``) is absent from the snapshot; only the call contract
survives: a 5-column text file read from a start line for N lines, returning
(time, radar-relative range, radar-relative velocity, azimuth, height), with
zero range/velocity entries treated as invalid (:577-588) and GPS timestamps
mapped to radar frame indices via the frame accumulation time and a
per-experiment shift (:571-573).  This module implements that contract.

The port's own copy of the JAX package's ``evalx/gps.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GPSTrack(NamedTuple):
    time_s: np.ndarray
    range_m: np.ndarray
    velocity_ms: np.ndarray
    azimuth_deg: np.ndarray
    height_m: np.ndarray


def read_gps_track(
    path: str,
    n_cols: int = 5,
    start_line: int = 1,
    n_lines: int | None = None,
) -> GPSTrack:
    """Read a whitespace/comma-separated GPS track file.

    ``start_line`` is 1-based (the reference's START_LINE_GPS); rows with
    fewer than ``n_cols`` values are skipped.
    """
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh, start=1):
            if i < start_line:
                continue
            if n_lines is not None and len(rows) >= n_lines:
                break
            parts = line.replace(",", " ").split()
            if len(parts) < n_cols:
                continue
            try:
                rows.append([float(p) for p in parts[:n_cols]])
            except ValueError:
                continue
    data = np.asarray(rows, dtype=np.float64).reshape(-1, n_cols)
    return GPSTrack(*(data[:, i] for i in range(5)))


def gps_frame_indices(
    track: GPSTrack, prt: float, prt_num: int, frames_shift: int = 0
) -> np.ndarray:
    """GPS timestamps -> radar frame indices.

    ``frameTimeRadar = prt * prtNum``; indices are relative to the first GPS
    sample plus the per-experiment shift (:571-573).
    """
    frame_time = prt * prt_num
    return (track.time_s - track.time_s[0]) / frame_time + frames_shift


def drop_invalid(track: GPSTrack, frame_idx: np.ndarray):
    """Remove entries with zero range or velocity (:577-588)."""
    bad = (track.range_m == 0) | (track.velocity_ms == 0)
    keep = ~bad
    return (
        GPSTrack(*(f[keep] for f in track)),
        frame_idx[keep],
    )


def compare_estimates(
    frame_idx_radar: np.ndarray,
    est_radar: np.ndarray,
    frame_idx_gps: np.ndarray,
    est_gps: np.ndarray,
) -> dict:
    """Interpolate the GPS track onto radar frames and report residuals."""
    order = np.argsort(frame_idx_gps)
    gi, ge = frame_idx_gps[order], est_gps[order]
    lo, hi = gi[0], gi[-1]
    mask = (frame_idx_radar >= lo) & (frame_idx_radar <= hi)
    if not mask.any():
        return {"n": 0, "rmse": float("nan"), "bias": float("nan")}
    interp = np.interp(frame_idx_radar[mask], gi, ge)
    resid = est_radar[mask] - interp
    return {
        "n": int(mask.sum()),
        "rmse": float(np.sqrt(np.mean(resid**2))),
        "bias": float(np.mean(resid)),
        "max_abs": float(np.max(np.abs(resid))),
    }

"""Dataset utilities (reference D4, SURVEY.md §2.4).

* ``crop_velocity_band`` — generalized RDM velocity crop; the reference
  hard-codes rows 691:845 of the 1536-row G1 RDM (about +-20 m/s)
  (``clip.m:12-13``, ``main_produce_dataset_win_xzr.m:37-42``);
* ``extract_angle_series`` — batch extraction of per-frame servo-angle
  series from a frame-manifest directory (``angle_read.m:11-68``, which
  repeats the loop per experiment; here one call per directory);
* ``sinc2d`` — the 2-D sinc demo surface (``ywoD_sinc.m:1-14``).

The port's own copy of the JAX package's ``utils/dataset.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.utils.manifest import frame_exists, load_frame


def velocity_band_rows(
    profile: RadarProfile, n_pulses: int, v_min: float, v_max: float
) -> Tuple[int, int]:
    """Row range [lo, hi) of the shifted RDM covering [v_min, v_max] m/s."""
    v_axis = profile.velocity_axis(n_pulses)
    keep = np.nonzero((v_axis >= v_min) & (v_axis <= v_max))[0]
    if len(keep) == 0:
        raise ValueError("velocity band outside the unambiguous range")
    return int(keep[0]), int(keep[-1]) + 1


def crop_velocity_band(
    rdm: np.ndarray,
    profile: RadarProfile,
    v_min: float = -20.0,
    v_max: float = 20.0,
):
    """Crop the RDM's velocity axis (-2) to a physical band."""
    lo, hi = velocity_band_rows(profile, rdm.shape[-2], v_min, v_max)
    return rdm[..., lo:hi, :], (lo, hi)


def extract_angle_series(frames_dir: str, max_frames: int = 10_000) -> np.ndarray:
    """Concatenate ``servo_angle`` across all frames of a manifest directory."""
    series = []
    idx = 0
    while idx < max_frames and frame_exists(frames_dir, idx):
        arrays, _, _ = load_frame(frames_dir, idx)
        series.append(np.asarray(arrays["servo_angle"]).ravel())
        idx += 1
    if not series:
        return np.zeros(0)
    return np.concatenate(series)


def sinc2d(n: int = 101, extent: float = 8.0) -> np.ndarray:
    """2-D sinc surface demo (``ywoD_sinc.m``)."""
    x = np.linspace(-extent, extent, n)
    r = np.hypot(*np.meshgrid(x, x))
    return np.sinc(r / np.pi)


def load_stc_curve(path: str, max_len: int | None = None) -> np.ndarray:
    """Load an STC gain curve (dB) with the MATLAB ``textread('%f')`` contract.

    ``fun_iSTC.m:5-6`` reads the curve as whitespace-separated floats (the
    commented-out ``stcCurve.txt`` path documents the intended 1025-value
    fixture; the ``DJIFlightRecord_*`` path it actually names ships as a
    BINARY DJI flight log in the reference snapshot, on which MATLAB's
    ``textread`` errors just as this does).  Returns a 1-D float64 array;
    ``max_len`` truncates (the consumer zero-pads to the fast-time length,
    ``ops.mtd.istc_compensate``).
    """
    with open(path, "rb") as f:
        raw = f.read()
    try:
        text = raw.decode("ascii")
    except UnicodeDecodeError as e:
        raise ValueError(
            f"{path}: not a text STC curve (binary content at byte {e.start}"
            "); the reference's shipped DJIFlightRecord_*.txt is a binary "
            "flight log — supply the stcCurve.txt-style float file "
            "fun_iSTC.m:5 documents"
        ) from None
    tokens = text.split()
    if not tokens:
        raise ValueError(f"{path}: empty STC curve")
    try:
        vals = np.array([float(t) for t in tokens], dtype=np.float64)
    except ValueError:
        bad = next(t for t in tokens if not _is_float(t))
        raise ValueError(
            f"{path}: non-numeric token {bad!r} in STC curve"
        ) from None
    return vals[:max_len] if max_len else vals


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False

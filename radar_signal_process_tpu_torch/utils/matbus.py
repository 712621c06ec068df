"""MATLAB ``.mat`` file-bus interoperability.

The reference's stages communicate through directories of per-frame MATLAB
``.mat`` files (``README.md:178-183``).  This module reads and writes those
exact variable contracts, so datasets produced by the reference's MATLAB
stages flow directly into this framework and framework outputs can be loaded
back into the MATLAB tooling:

* **stage-1 frames** — ``frame_N.mat`` holding ``sig_data_DBF_allprts``
  (prt x sample x beam complex) and ``servo_angle``
  (``bin_to_mat_xzr.m:66``; consumed at
  ``main_produce_dataset_win_xzr_v2.m:77-97``);
* **stage-2 MTD** — ``frame_N.mat`` holding the cell array
  ``MTD_win_all_beams`` with one ``(win, velocity, range)`` entry per beam
  (``main_produce_dataset_win_xzr_v2.m:162``,
  ``analyze_and_plot_mtd_results.m:48-49``); the G1 two-beam stage instead
  stores plain ``MTD_0``/``MTD_1`` matrices (loaded at ``main_cfar.m:83``);
* **stage-3 CFAR flags** — ``cfarFlag{win}_T{T}/frame_N.mat`` holding
  ``cfarFlag_win_0``/``cfarFlag_win_1`` ``(win, velocity, range)`` stacks,
  one variable per beam (``main_cfar.m:74,97``).

MATLAB default saves are v7 (scipy-readable); v7.3/HDF5 files are out of
scope and raise scipy's NotImplementedError unchanged.

The port's own copy of the JAX package's ``utils/matbus.py``;
``tests/test_torch_import.py`` holds its code equal to the original.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


def _sio():
    import scipy.io as sio

    return sio


def mat_frame_path(directory: str, frame_idx: int) -> str:
    """Reference naming contract ``frame_N.mat`` (0-based frame index)."""
    return os.path.join(directory, f"frame_{frame_idx}.mat")


def mat_frame_exists(directory: str, frame_idx: int) -> bool:
    return os.path.exists(mat_frame_path(directory, frame_idx))


def baseband_dir(root: str) -> str:
    """Stage-1 output directory name (``README.md:178``)."""
    return os.path.join(root, "BasebandRawData_mat")


def mtd_dir(root: str, win_size: int) -> str:
    """Stage-2 output directory name (``main_produce_dataset_win_xzr_v2.m:51``)."""
    return os.path.join(root, f"MTD_data_win{win_size}")


def cfar_dir(root: str, win_size: int, threshold: float) -> str:
    """Stage-3 output directory name (``main_cfar.m:74``)."""
    t = int(threshold) if float(threshold).is_integer() else threshold
    return os.path.join(root, f"cfarFlag{win_size}_T{t}")


# ---------------------------------------------------------------- stage 1

def save_frame_mat(path: str, iq: np.ndarray, servo_angle: np.ndarray) -> str:
    """Write a stage-1 frame: ``sig_data_DBF_allprts`` + ``servo_angle``.

    ``iq``: (prt, sample, beam) complex — the exact in-memory orientation the
    reference saves (``FrameDataRead_xzr.m:200``, ``bin_to_mat_xzr.m:66``).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _sio().savemat(
        path,
        {
            "sig_data_DBF_allprts": np.asarray(iq),
            "servo_angle": np.asarray(servo_angle, dtype=np.float64).reshape(1, -1),
        },
        do_compression=True,
    )
    return path


def save_g1_frame_mat(
    path: str, left: np.ndarray, right: np.ndarray, angle_codes: np.ndarray
) -> str:
    """Write a G1 stage-1 frame: the two-beam contract the reference's G1
    driver saves (``MatlabProcess_xuzerui/bin_to_mat_xzr.m:18-20``):
    ``echoData_Frame_0`` / ``echoData_Frame_1`` (prt, sample) complex plus
    the per-PRT ``angleCodeSeries``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _sio().savemat(
        path,
        {
            "echoData_Frame_0": np.asarray(left),
            "echoData_Frame_1": np.asarray(right),
            "angleCodeSeries": np.asarray(
                angle_codes, dtype=np.float64
            ).reshape(1, -1),
        },
        do_compression=True,
    )
    return path


def load_frame_mat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a stage-1 frame -> (iq (prt, sample, beam), servo_angle (prt,)).

    Accepts both reference contracts: the G2 ``sig_data_DBF_allprts`` beam
    cube and the G1 two-beam ``echoData_Frame_0``/``echoData_Frame_1`` pair
    (whose ``angleCodeSeries`` maps onto the servo-angle slot).
    """
    m = _sio().loadmat(path)
    if "sig_data_DBF_allprts" in m:  # main_produce_dataset_win_xzr_v2.m:89-93
        iq = np.asarray(m["sig_data_DBF_allprts"])
        if iq.ndim == 2:  # single-beam saves lose the trailing singleton
            iq = iq[:, :, None]
        servo = np.asarray(m.get("servo_angle", np.zeros((1, iq.shape[0])))).ravel()
        return iq, servo
    if "echoData_Frame_0" in m:
        iq = np.stack(
            [np.asarray(m["echoData_Frame_0"]), np.asarray(m["echoData_Frame_1"])],
            axis=-1,
        )
        servo = np.asarray(
            m.get("angleCodeSeries", np.zeros((1, iq.shape[0])))
        ).ravel()
        return iq, servo
    raise KeyError(
        f"{path}: no 'sig_data_DBF_allprts' or 'echoData_Frame_0' variable "
        f"(keys: {[k for k in m if not k.startswith('__')]})"
    )


# ---------------------------------------------------------------- stage 2

def save_mtd_mat(path: str, rdms: np.ndarray, two_beam_vars: bool = False) -> str:
    """Write stage-2 RDMs as the ``MTD_win_all_beams`` cell array.

    ``rdms``: (beam, win, velocity, range) real magnitudes.  Saved as a
    (beam, 1) cell of (win, velocity, range) arrays — byte-compatible with
    ``save(output_filename, 'MTD_win_all_beams')``.  With
    ``two_beam_vars=True`` (G1's two-beam stage), writes the older
    ``MTD_0`` / ``MTD_1`` variable pair instead
    (``MTD/main_produce_dataset_win_xzr.m:37-42`` save contract).
    """
    rdms = np.asarray(rdms)
    if rdms.ndim != 4:
        raise ValueError(f"rdms must be (beam, win, v, r), got {rdms.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if two_beam_vars:
        if rdms.shape[0] != 2:
            raise ValueError(
                f"two_beam_vars needs exactly 2 beams, got {rdms.shape[0]}"
            )
        _sio().savemat(
            path, {"MTD_0": rdms[0], "MTD_1": rdms[1]}, do_compression=True
        )
        return path
    cell = np.empty((rdms.shape[0], 1), dtype=object)
    for b in range(rdms.shape[0]):
        cell[b, 0] = rdms[b]
    _sio().savemat(path, {"MTD_win_all_beams": cell}, do_compression=True)
    return path


def load_mtd_mat(path: str) -> np.ndarray:
    """Read stage-2 RDMs -> (beam, win, velocity, range).

    Accepts both reference forms: the G2 ``MTD_win_all_beams`` cell array and
    the G1 two-beam ``MTD_0``/``MTD_1`` (win, velocity, range) stacks.
    """
    m = _sio().loadmat(path)
    if "MTD_win_all_beams" in m:
        cell = m["MTD_win_all_beams"]
        beams = [np.asarray(cell[b].item() if cell[b].size == 1 else cell[b])
                 for b in range(cell.shape[0])]
        return np.stack(beams, axis=0)
    g1 = [k for k in ("MTD_0", "MTD_1") if k in m]
    if g1:
        return np.stack([np.asarray(m[k]) for k in g1], axis=0)
    raise KeyError(
        f"{path}: no 'MTD_win_all_beams' or 'MTD_0'/'MTD_1' variables "
        f"(keys: {[k for k in m if not k.startswith('__')]})"
    )


# ---------------------------------------------------------------- stage 3

def save_cfar_mat(path: str, flags: np.ndarray) -> str:
    """Write stage-3 flags as ``cfarFlag_win_{beam}`` variables.

    ``flags``: (beam, win, velocity, range) bool/0-1.  The reference saves
    ``cfarFlag_win_0``/``cfarFlag_win_1`` for its two beams
    (``main_cfar.m:94-97``); beams beyond two extend the same numbering.
    """
    flags = np.asarray(flags)
    if flags.ndim == 3:
        flags = flags[None]
    payload: Dict[str, np.ndarray] = {
        f"cfarFlag_win_{b}": flags[b].astype(np.float64)
        for b in range(flags.shape[0])
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _sio().savemat(path, payload, do_compression=True)
    return path


def load_cfar_mat(path: str) -> np.ndarray:
    """Read stage-3 flags -> (beam, win, velocity, range) bool."""
    m = _sio().loadmat(path)
    keys = sorted(
        (k for k in m if k.startswith("cfarFlag_win_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    if not keys:
        raise KeyError(f"{path}: no 'cfarFlag_win_*' variables")
    return np.stack([np.asarray(m[k]) != 0 for k in keys], axis=0)

"""ctypes binding of the native C++ CFAR cascade, built on first use.

Port of ``radar_signal_process_tpu/kernels/native_cfar.py``.  ``native/cfar.cpp``
(a byte-identical copy of the JAX package's) computes the cascaded 2-D CFAR
of one transposed (n_range, n_velocity) RDM on the host in one pass,
bit-identical to ``ops.cfar``'s split form (``segmented_cfar_flags`` +
``segmented_cfar_select`` with ``transposed=True``).  It is the host's CFAR
where no card is present (``models.detect.make_cascade_detector``); it never
takes a CUDA tensor.

The library is compiled with g++ to a content-hash-named ``.so`` beside the
source (``*.so`` is git-ignored), written to a temporary name and
``os.replace``d into place, so processes that build at once never load a
half-written file and ``dlopen``'s per-path cache never pins a stale image.
Without a toolchain :func:`native_cfar_available` is False and
:func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import CFARConfig, matlab_round

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "cfar.cpp")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def lib_path() -> str:
    """Path of the library built from the current source."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_NATIVE_DIR, f"libcfar-{digest}.so")


def _build(path: str) -> Optional[str]:
    # -ffp-contract=off: no float op sequence may drift from the split
    # form's (the parity contract is bit-exactness)
    tmp = f"{path[:-3]}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp, _SRC]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"g++ unavailable: {e}"
        if proc.returncode != 0:
            return f"build failed: {proc.stderr[-2000:]}"
        os.replace(tmp, path)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rsp_cfar_cascade_t.restype = ctypes.c_int
    lib.rsp_cfar_cascade_t.argtypes = [
        ctypes.POINTER(ctypes.c_float),                            # rdm
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                  # n_r, n_v, n_clutter
        u8p,                                                       # notch mask / NULL
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # velocity cfg
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,  # range cfg
        ctypes.c_int, ctypes.c_int,                                # range_detect, ext
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,                # segments, n_segments
        u8p, u8p,                                                  # flags, vflags out
    ]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    path = lib_path()
    if not os.path.exists(path):
        _build_error = _build(path)
        if _build_error:
            return None
    try:
        _lib = _bind(ctypes.CDLL(path))
    except (OSError, AttributeError) as e:
        _build_error = f"library unusable: {e}"
        return None
    return _lib


def native_cfar_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def notch_mask_shifted(n_velocity: int, divisor: int) -> np.ndarray:
    """Per-velocity-cell uint8 mask, 1 = zeroed, of ``ops.mtd.zero_velocity_notch``."""
    hw = matlab_round(n_velocity / divisor)
    center = matlab_round(n_velocity / 2) - 1
    idx = np.arange(n_velocity)
    return ((idx >= center - hw) & (idx <= center + hw)).astype(np.uint8)


def notch_mask_unshifted(n_velocity: int, n_clutter: int) -> np.ndarray:
    """Per-velocity-cell mask of ``ops.mtd.zero_velocity_notch_unshifted``."""
    idx = np.arange(n_velocity)
    return ((idx <= n_clutter) | (idx >= n_velocity - n_clutter)).astype(np.uint8)


def make_native_cascade(
    n_clutter: int,
    cfg: CFARConfig,
    cfg_range: CFARConfig | None = None,
    segments: Sequence[Tuple[int, int]] = (),
    notch_mask: np.ndarray | None = None,
):
    """The native cascade over ONE transposed RDM: (n_r, n_v) float32, a CPU
    tensor or a numpy array -> bool CPU tensors ``(flags, vflags)``.

    Bit-identical to ``models.detect.make_split_detector(transposed=True)``
    with the same re-notch (pass the matching ``notch_mask``).  ``segments``
    are range-axis (row) bounds; empty means the full width.  The callable is
    thread-safe (the C side is reentrant) and ctypes releases the GIL while
    it runs.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native CFAR unavailable: {_build_error}")
    cfg_r = cfg_range or cfg
    mask = None if notch_mask is None else np.ascontiguousarray(notch_mask, np.uint8)

    def cascade(rdm_t) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(rdm_t, torch.Tensor):
            if rdm_t.device.type != "cpu":
                raise ValueError(f"the native cascade runs on the host, got {rdm_t.device}")
            rdm_t = rdm_t.numpy()
        a = np.ascontiguousarray(rdm_t, np.float32)
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D transposed RDM, got {a.shape}")
        n_r, n_v = a.shape
        segs = list(segments) or [(0, n_r)]
        for start, stop in segs:
            # the C side indexes rows by these bounds unchecked
            if not 0 <= start < stop <= n_r:
                raise ValueError(f"segment ({start}, {stop}) outside the {n_r}-row RDM")
        seg_arr = np.ascontiguousarray(np.asarray(segs, np.int32).reshape(-1))
        if mask is not None and mask.shape[0] != n_v:
            raise ValueError(f"notch mask length {mask.shape[0]} != n_velocity {n_v}")
        flags = np.empty((n_r, n_v), np.uint8)
        vflags = np.empty((n_r, n_v), np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        rc = lib.rsp_cfar_cascade_t(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_r, n_v, n_clutter,
            mask.ctypes.data_as(u8p) if mask is not None else None,
            cfg.ref_cells, cfg.guard_cells, cfg.method, ctypes.c_float(cfg.threshold),
            cfg_r.ref_cells, cfg_r.guard_cells, cfg_r.method, ctypes.c_float(cfg_r.threshold),
            int(cfg.range_detect), cfg.range_extend_cells,
            seg_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(segs),
            flags.ctypes.data_as(u8p), vflags.ctypes.data_as(u8p),
        )
        if rc != 0:
            raise RuntimeError(f"rsp_cfar_cascade_t failed with code {rc}")
        return torch.from_numpy(flags.view(bool)), torch.from_numpy(vflags.view(bool))

    return cascade

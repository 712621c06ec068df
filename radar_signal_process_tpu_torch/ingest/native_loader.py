"""ctypes binding for the native ingest library, with build-on-demand.

The shared library is compiled from ``native/ingest.cpp`` on first use and
cached next to the source (``*.so`` is git-ignored).  g++ writes to a
temporary name that is then ``os.replace``d into place, so processes that
build at once never load a half-written file.  When no C++ toolchain is
available the import still succeeds and ``native_available()`` returns
False — callers fall back to the NumPy parsers in ``packets.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from radar_signal_process_tpu_torch.config import G2_PROFILE, RadarProfile
from radar_signal_process_tpu_torch.ingest.packets import FrameResult
from radar_signal_process_tpu_torch.ingest.paths import G2_RAW_SUBDIR, g1_file_path

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_NATIVE_DIR, "ingest.cpp")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _lib_path() -> str:
    """Shared-library path keyed on the source content hash.

    Binaries are never committed (host-specific: -march=native) and a
    source change yields a new filename, so a stale or foreign `.so` can
    never be picked up — and dlopen's per-path caching can never pin an
    old image after a rebuild.
    """
    import hashlib

    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_NATIVE_DIR, f"libingest-{digest}.so")


def _build(lib_path: str) -> Optional[str]:
    tmp = f"{lib_path[:-3]}.{os.getpid()}.tmp.so"
    cmd = ["g++", "-O3", "-march=native", "-pthread", "-shared", "-fPIC",
           "-std=c++17", "-o", tmp, _SRC]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"g++ unavailable: {e}"
        if proc.returncode != 0:
            return f"build failed: {proc.stderr[-2000:]}"
        os.replace(tmp, lib_path)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    lib_path = _lib_path()
    if not os.path.exists(lib_path):
        _build_error = _build(lib_path)
        if _build_error:
            return None
    try:
        lib = _bind(ctypes.CDLL(lib_path))
    except (OSError, AttributeError):
        # e.g. a hash-named binary built by an incompatible host.  Rebuild
        # to a FRESH filename: dlopen caches by path, so if the first CDLL
        # succeeded but binding failed, a rebuild under the same name could
        # be silently shadowed by the stale in-process mapping.
        retry_path = lib_path[:-3] + f"-r{os.getpid()}.so"
        _build_error = _build(retry_path)
        if _build_error:
            return None
        try:
            lib = _bind(ctypes.CDLL(retry_path))
        except (OSError, AttributeError) as e2:
            _build_error = f"rebuilt library unusable: {e2}"
            return None
    _lib = lib
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol; raises AttributeError on a stale lib."""
    lib.rsp_stream_open.restype = ctypes.c_void_p
    lib.rsp_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.rsp_stream_read.restype = ctypes.c_int64
    lib.rsp_stream_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.rsp_stream_close.argtypes = [ctypes.c_void_p]
    lib.rsp_g2_open.restype = ctypes.c_void_p
    lib.rsp_g2_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p] + [ctypes.c_int] * 6
    lib.rsp_g2_read_frame.restype = ctypes.c_int
    lib.rsp_g2_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rsp_g2_read_frame_mt.restype = ctypes.c_int
    lib.rsp_g2_read_frame_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.rsp_g2_close.argtypes = [ctypes.c_void_p]
    lib.rsp_g1_read_frame.restype = ctypes.c_int
    lib.rsp_g1_read_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class NativeG2FrameReader:
    """C++-backed G2 frame reader; drop-in for ``packets.G2FrameReader``."""

    def __init__(self, root: str, profile: RadarProfile = G2_PROFILE,
                 n_threads: int | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native ingest unavailable: {_build_error}")
        self._lib = lib
        self.profile = profile
        # n_threads > 1 selects the two-phase parse (sequential packet read,
        # threaded int16->float conversion).  Default stays the interleaved
        # single-pass parser: staging the whole frame before converting
        # evicts each payload from L2 between read and convert, which cost
        # more than 2 threads bought back on a 2-core host
        # (measured 616 vs 890 MB/s); wider hosts can opt in.
        self.n_threads = n_threads or 1
        sub = os.path.join(root, G2_RAW_SUBDIR)
        base = sub if os.path.isdir(sub) else root
        self._handle = lib.rsp_g2_open(
            base.encode(), b"1.%06d.bin",
            profile.prt_per_frame, profile.point_prt, profile.n_channels,
            profile.bytes_head, profile.bytes_realtime, profile.bytes_tail,
        )
        self._pending_idx: int | None = None
        self._pending: tuple | None = None

    def read_frame(self, frame_idx: int) -> FrameResult:
        prof = self.profile
        # Mid-frame resume parity with packets.G2FrameReader: the C side
        # resumes parsing at its PRT cursor, so the Python buffers for the
        # same logical frame must persist across retries or the earlier PRTs
        # would come back zeroed.
        if self._pending_idx == frame_idx and self._pending is not None:
            iq, angles = self._pending
        else:
            iq = np.zeros(
                (prof.prt_per_frame, prof.point_prt, prof.n_channels),
                dtype=np.complex64,
            )
            angles = np.zeros(prof.prt_per_frame, dtype=np.float64)
            self._pending_idx = frame_idx
            self._pending = (iq, angles)
        prts_read = ctypes.c_int(0)
        eos = ctypes.c_int(0)
        if self.n_threads > 1:
            done = self._lib.rsp_g2_read_frame_mt(
                self._handle, frame_idx,
                iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.byref(prts_read), ctypes.byref(eos),
                self.n_threads,
            )
        else:
            done = self._lib.rsp_g2_read_frame(
                self._handle, frame_idx,
                iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.byref(prts_read), ctypes.byref(eos),
            )
        if done:
            self._pending_idx = None
            self._pending = None
        return FrameResult(iq, angles, bool(done), bool(eos.value), {})

    def close(self) -> None:
        if self._handle:
            self._lib.rsp_g2_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeG1FrameReader:
    """C++-backed drop-in for ``packets.G1FrameReader``."""

    def __init__(
        self, root: str, prt_num: int = 1536, point_prt: int = 1031,
        frames_per_file: int = 10,
    ):
        if _load() is None:
            raise RuntimeError(f"native ingest unavailable: {_build_error}")
        self.root = root
        self.prt_num = prt_num
        self.point_prt = point_prt
        self.frames_per_file = frames_per_file

    def read_frame(self, frame_idx: int):
        file_ind = (frame_idx - 1) // self.frames_per_file + 1
        return native_g1_read_frame(
            g1_file_path(self.root, file_ind), frame_idx,
            self.prt_num, self.point_prt, self.frames_per_file,
        )


def native_g1_read_frame(
    path: str, frame_idx: int, prt_num: int = 1536, point_prt: int = 1031,
    frames_per_file: int = 10,
):
    """C++-backed G1 frame parse; mirrors ``packets.G1FrameReader.read_frame``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest unavailable: {_build_error}")
    bytes_per_prt = 28 + 12 * point_prt + 8
    frame_skip = (frame_idx - 1) % frames_per_file
    offset = bytes_per_prt * prt_num * frame_skip
    left = np.zeros((prt_num, point_prt), dtype=np.complex64)
    right = np.zeros((prt_num, point_prt), dtype=np.complex64)
    angles = np.zeros(prt_num, dtype=np.float64)
    meta = np.zeros(6, dtype=np.int32)
    rc = lib.rsp_g1_read_frame(
        path.encode(), offset, prt_num, point_prt,
        left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        angles.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise IOError(f"rsp_g1_read_frame failed with code {rc}")
    return left, right, angles, dict(
        frame_no=int(meta[0]), mod_flag=int(meta[1]), beam_pos=int(meta[2]),
        beam_nums=int(meta[3]), freq_index=int(meta[4]), prt_no=int(meta[5]),
    )

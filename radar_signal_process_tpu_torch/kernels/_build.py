"""Build the Hopper kernels with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc, all started together,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -Xptxas -v -c -o <src>.o csrc/<src>.cu            # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/librsp_kernels-<hash>.so *.o

The library is named after a hash of the sources and flags (``dlopen``
caches by path, so a rebuilt library under the old name would pin the stale
image) and is built on first use into ``kernels/_build/``.  The compile
writes to a temporary name and ``os.replace``s it into place, so concurrent
processes never load a half-written file.  No ``--use_fast_math``: division
and square root stay IEEE (``-prec-div=true``, ``-prec-sqrt=true``).
``-Xptxas -v``'s register and spill report of every source is kept beside
the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: name -> argument types; each returns an int (a cudaError_t
# for the launches, a byte count for the shared-memory query)
_SIGNATURES = {
    "rsp_doppler_rdm": (_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "rsp_doppler_rdm_split_w": (_P, _P, _P, _L, _I, _I, _P),
    "rsp_doppler_rdm_smem_bytes": (),
    "rsp_cascaded_cfar": (_P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _I, _I, _I, _I,
                          _I, _F, _I, _I, _I, _I, _I, _P),
    "rsp_check_div5": (_P, _P),
    "rsp_cascaded_cfar_smem_bytes": (_I, _I, _I, _I),
    "rsp_fused_pc_rdm": (_P, _L, _I, _P, _L, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P),
    "rsp_fused_pc_rdm_split_m": (_P, _P, _P, _L, _I, _I, _P),
    "rsp_fused_pc_rdm_smem_bytes": (),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Content-addressed path of the library for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librsp_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (no nvcc on PATH and no CUDA toolkit at CUDA_HOME): "
        "the CUDA kernels cannot be built"
    )


def build() -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    objs = []
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objs.append(obj)
            jobs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )))
        logs, failed = [], []
        for src, proc in jobs:
            _, err = proc.communicate()
            logs.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")

"""B2: fused RDM former — windowed Doppler DFT + magnitude + notch.

Replaces ``radar_signal_process_tpu/kernels/rdm_pallas.py::
doppler_rdm_pallas``.  ``out = |W . X|`` with the zero-velocity notch rows
set to zero, where W is the (n_fft, n) windowed, fftshift-folded DFT plane
built on the host in float64 (``ops.mtd.dft_plane``) and held as float32
re/im planes, exactly as the Pallas wrapper casts it.

On a CUDA tensor :func:`doppler_rdm` launches ``csrc/rdm.cu``: a tiled
complex GEMM on the tensor cores at FP32 accuracy (the 3xTF32 split of
``csrc/cgemm_3xtf32.cuh``, a 3-stage ``cp.async`` ring) with the magnitude
and the notch as its epilogue.  At G2 it does ~156 GFLOP per window (52 x 4
real 332 x 332 x 3404 GEMMs) against ~0.7 GB of traffic, so it is bound by
arithmetic.  On a CPU tensor it runs :func:`doppler_rdm_plain`, the
complex64 matmul, ``abs`` and the notch — equal to
``ops.mtd.doppler_process(use_matmul=True)`` + ``zero_velocity_notch``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.ops.mtd import dft_plane


def dft_planes(
    window: np.ndarray, n_fft: int | None = None, shift: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (re, im) planes of the windowed DFT plane, (n_fft, n) each."""
    w = dft_plane(window, n_fft, shift)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def doppler_rdm_plain(
    pc: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor, notch: Tuple[int, int]
) -> torch.Tensor:
    """Plain version: complex64 matmul, magnitude, notch rows zeroed."""
    mag = torch.matmul(torch.complex(w_re, w_im), pc).abs()
    lo, hi = notch
    if hi >= lo:
        mag[..., lo : hi + 1, :] = 0.0
    return mag


def doppler_rdm(
    pc: torch.Tensor, w_re: torch.Tensor, w_im: torch.Tensor, notch: Tuple[int, int]
) -> torch.Tensor:
    """Compressed pulses (..., n, n_range) complex64 -> (..., n_fft, n_range)
    float32 RDM, rows ``notch[0]..notch[1]`` (inclusive) zero.

    CPU tensor: :func:`doppler_rdm_plain`.  CUDA tensor: the kernel, or an
    exception; ``doppler_rdm.launches`` counts the kernel launches.
    """
    n, nr = pc.shape[-2], pc.shape[-1]
    n_fft = w_re.shape[0]
    if w_re.shape != (n_fft, n) or w_im.shape != w_re.shape:
        raise ValueError(f"DFT planes {tuple(w_re.shape)} do not match {n} pulses")
    if pc.device.type == "cpu":
        return doppler_rdm_plain(pc, w_re, w_im, notch)
    if pc.device.type != "cuda":
        raise ValueError(f"doppler_rdm: unsupported device {pc.device}")
    for name, t, dtype in (("pc", pc, torch.complex64), ("w_re", w_re, torch.float32),
                           ("w_im", w_im, torch.float32)):
        if t.dtype != dtype or t.device != pc.device or not t.is_contiguous():
            raise ValueError(
                f"doppler_rdm: {name} must be a contiguous {dtype} tensor on "
                f"{pc.device}, got {t.dtype} on {t.device}"
            )
    batch_shape = pc.shape[:-2]
    batch = int(np.prod(batch_shape, dtype=np.int64))
    if not 0 < batch <= 65535:
        raise ValueError(f"doppler_rdm: batch {batch} outside 1..65535")
    out = torch.empty(batch_shape + (n_fft, nr), dtype=torch.float32, device=pc.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(pc.device).cuda_stream
    # 16-byte copies: 4 pulses of a W row, 2 samples of an X row
    w_vec = int(n % 4 == 0 and w_re.data_ptr() % 16 == 0 and w_im.data_ptr() % 16 == 0)
    x_vec = int(nr % 2 == 0 and pc.data_ptr() % 16 == 0)
    rc = lib.rsp_doppler_rdm(
        w_re.data_ptr(), w_im.data_ptr(), pc.data_ptr(), out.data_ptr(),
        batch, n_fft, n, nr, int(notch[0]), int(notch[1]), w_vec, x_vec, stream,
    )
    _build.check(rc, "rsp_doppler_rdm")
    doppler_rdm.launches += 1
    return out


doppler_rdm.launches = 0

"""B2: fused RDM former — windowed Doppler DFT + magnitude + notch.

Replaces ``radar_signal_process_tpu/kernels/rdm_pallas.py::
doppler_rdm_pallas``.  ``out = |W . X|`` with the zero-velocity notch rows
set to zero, where W is the (n_fft, n) windowed, fftshift-folded DFT plane
built on the host in float64 (``ops.mtd.dft_plane``) and held as float32
re/im planes, exactly as the Pallas wrapper casts it.

On a CUDA tensor :func:`doppler_rdm` launches ``csrc/rdm.cu``: a small
kernel splits W into four TF32 planes laid out as the main kernel's
shared-memory tiles (:func:`wgmma_b_planes`, into a scratch buffer of this
call), then the main kernel forms each tile transposed,
``D^T = Xr^T B_r + Xi^T B_i``, with Hopper's ``wgmma`` at FP32 accuracy
(3xTF32, X split in registers as the A operand, the W tiles brought in by
TMA bulk copies through an mbarrier ring) and the magnitude and the notch
as its epilogue.  At G2 it does ~156 GFLOP per window (52 x 4 real
332 x 332 x 3404 GEMMs) against ~0.7 GB of traffic, so it is bound by
arithmetic.  On a CPU tensor it runs :func:`doppler_rdm_plain`, the
complex64 matmul, ``abs`` and the notch — equal to
``ops.mtd.doppler_process(use_matmul=True)`` + ``zero_velocity_notch``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.ops.mtd import dft_plane

# csrc/rdm.cu's tiling: Doppler rows per block (the wgmma's N is twice it:
# re then im) and pulses per stage of its ring
TILE_ROWS, STAGE_PULSES = 48, 16


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


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo) with hi = rna_tf32(x), lo = rna_tf32(x - hi): the
    split of ``csrc/cgemm_3xtf32.cuh`` (round to nearest, ties away from
    zero, to 10 mantissa bits, as an integer add and mask of the bits)."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def wgmma_b_planes_plain(w_re: torch.Tensor, w_im: torch.Tensor) -> torch.Tensor:
    """Plain version of the W split: the B operands of the transposed real
    form, ``B_r = [Wr; Wi]`` and ``B_i = [-Wi; Wr]`` over each tile of
    TILE_ROWS Doppler rows (re rows first, then im), split into TF32 hi/lo,
    zero-padded to whole tiles and stages, in the kernel's shared-memory
    image: ``[tile][stage][plane][n // 8][p // 4][n % 8][p % 4]`` with
    planes B_r hi, B_r lo, B_i hi, B_i lo, ``n < 2 TILE_ROWS`` and
    ``p < STAGE_PULSES`` (8-row x 4-pulse core matrices, 128 bytes each)."""
    n_fft, n = w_re.shape
    tiles, stages = -(-n_fft // TILE_ROWS), -(-n // STAGE_PULSES)

    def tiled(w):  # (tiles, TILE_ROWS, stages * STAGE_PULSES), zero-padded
        pad = (0, stages * STAGE_PULSES - n, 0, tiles * TILE_ROWS - n_fft)
        return F.pad(w, pad).view(tiles, TILE_ROWS, stages * STAGE_PULSES)

    wr, wi, nwi = tiled(w_re), tiled(w_im), tiled(-w_im)
    b_r = _tf32_split(torch.cat([wr, wi], dim=1))
    b_i = _tf32_split(torch.cat([nwi, wr], dim=1))
    planes = torch.stack([*b_r, *b_i], dim=1)  # (tiles, 4, 2 TILE_ROWS, pulses)
    planes = planes.view(tiles, 4, 2 * TILE_ROWS // 8, 8, stages, STAGE_PULSES // 4, 4)
    return planes.permute(0, 4, 1, 2, 5, 3, 6).contiguous()


def wgmma_b_planes(w_re: torch.Tensor, w_im: torch.Tensor) -> torch.Tensor:
    """The W split that :func:`doppler_rdm` runs first on the card, alone:
    CPU tensors get :func:`wgmma_b_planes_plain`, CUDA tensors the split
    kernel of ``csrc/rdm.cu`` (bit for bit the same planes).  Counts no
    launch: it is part of a B2 call."""
    _check_planes(w_re, w_im, w_re.shape[-1])
    if w_re.device.type == "cpu":
        return wgmma_b_planes_plain(w_re, w_im)
    _check_cuda(w_re.device, (("w_re", w_re, torch.float32), ("w_im", w_im, torch.float32)))
    ws = _workspace(w_re)
    rc = _build.library().rsp_doppler_rdm_split_w(
        w_re.data_ptr(), w_im.data_ptr(), ws.data_ptr(), ws.numel(), *w_re.shape,
        torch.cuda.current_stream(w_re.device).cuda_stream,
    )
    _build.check(rc, "rsp_doppler_rdm_split_w")
    return ws


def _workspace(w_re: torch.Tensor) -> torch.Tensor:
    n_fft, n = w_re.shape
    shape = (-(-n_fft // TILE_ROWS), -(-n // STAGE_PULSES), 4, 2 * TILE_ROWS // 8,
             STAGE_PULSES // 4, 8, 4)
    return torch.empty(shape, dtype=torch.float32, device=w_re.device)


def _check_planes(w_re: torch.Tensor, w_im: torch.Tensor, n: int) -> None:
    n_fft = w_re.shape[0]
    if w_re.shape != (n_fft, n) or w_im.shape != w_re.shape:
        raise ValueError(f"DFT planes {tuple(w_re.shape)} do not match {n} pulses")


def _check_cuda(device: torch.device, tensors) -> None:
    if device.type != "cuda":
        raise ValueError(f"doppler_rdm: unsupported device {device}")
    for name, t, dtype in tensors:
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"doppler_rdm: {name} must be a contiguous {dtype} tensor on "
                f"{device}, got {t.dtype} on {t.device}"
            )


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
    _check_planes(w_re, w_im, n)
    if pc.device.type == "cpu":
        return doppler_rdm_plain(pc, w_re, w_im, notch)
    _check_cuda(pc.device, (("pc", pc, torch.complex64), ("w_re", w_re, torch.float32),
                            ("w_im", w_im, torch.float32)))
    batch_shape = pc.shape[:-2]
    batch = int(np.prod(batch_shape, dtype=np.int64))
    if not 0 < batch <= 65535:
        raise ValueError(f"doppler_rdm: batch {batch} outside 1..65535")
    lib = _build.library()
    smem = lib.rsp_doppler_rdm_smem_bytes()
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"doppler_rdm: a block needs {smem} B of shared memory (> {_build.SMEM_LIMIT})"
        )
    out = torch.empty(batch_shape + (n_fft, nr), dtype=torch.float32, device=pc.device)
    ws = _workspace(w_re)
    stream = torch.cuda.current_stream(pc.device).cuda_stream
    x_vec = int(nr % 2 == 0 and pc.data_ptr() % 16 == 0)  # 16-byte copies of 2 samples
    rc = lib.rsp_doppler_rdm(
        w_re.data_ptr(), w_im.data_ptr(), ws.data_ptr(), ws.numel(), pc.data_ptr(),
        out.data_ptr(), batch, n_fft, n, nr, int(notch[0]), int(notch[1]), x_vec, stream,
    )
    _build.check(rc, "rsp_doppler_rdm")
    doppler_rdm.launches += 1
    return out


doppler_rdm.launches = 0

"""B3: fused pulse compression + windowed Doppler DFT + magnitude.

Replaces ``radar_signal_process_tpu/kernels/pc_rdm_pallas.py::
fused_pc_rdm_pallas``.  ``out = |W . (X . M)|``: M is the per-row pulse
compression operator built on the host in float64
(:func:`pc_matrix_freq_domain` for the G0 long pulse's 512-point matched
filter, :func:`pc_matrix_fir` for the short pulse's raw-tap FIR), W the
windowed, zero-padded (n_fft, n_prt) DFT plane (``kernels.rdm.dft_planes``),
both held as float32 re/im planes as the Pallas wrapper casts them.

On a CUDA tensor :func:`fused_pc_rdm` launches ``csrc/pc_rdm.cu``: a
thread-block cluster owns a range tile of the compressed pulses
``P = X . M``; each block forms a slice of its rows in shared memory, and
every block contracts its share of the Doppler rows with the whole of P,
read from its peers through distributed shared memory.  Both products run
on the tensor cores at FP32 accuracy (the 3xTF32 split of
``csrc/cgemm_3xtf32.cuh``), with the magnitude as the epilogue; P never
reaches device memory.  A G0 frame is ~35 GFLOP of that work, so it is
bound by arithmetic.  The echo is read in place (unit fast-time stride, any
row stride), so the pulse segments of a beam need no copy.  On a CPU tensor
it runs :func:`fused_pc_rdm_plain`, two complex64 matmuls and ``abs``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radar_signal_process_tpu_torch.kernels import _build

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on Hopper


def pc_matrix_freq_domain(match_spec: np.ndarray, n_in: int, n_fft: int) -> np.ndarray:
    """(n_in, n_fft) complex128 matrix reproducing ``ifft(fft(x, n_fft) .* match_spec)``.

    ``match_spec`` is the frequency-domain matched filter
    (``conj(fft(win .* matchWaveform, 512))``).  MATLAB ``fft(x, n)`` (and
    ``torch.fft.fft(x, n)``) truncates to the first ``n`` samples when
    ``len(x) > n``, so the forward-DFT rows for samples ``p >= n_fft`` are
    zero rather than aliased.
    """
    p = np.arange(n_in)[:, None]
    k = np.arange(n_fft)[None, :]
    fwd = np.exp(-2j * np.pi * p * k / n_fft)           # (n_in, n_fft)
    fwd[n_fft:, :] = 0.0                                # fft(x, n) truncation
    n = np.arange(n_fft)[None, :]
    inv = np.exp(2j * np.pi * k.T * n / n_fft) / n_fft  # (n_fft, n_fft)
    return (fwd * np.asarray(match_spec)[None, :]) @ inv


def pc_matrix_fir(taps: np.ndarray, n_in: int) -> np.ndarray:
    """(n_in, n_in) causal-FIR Toeplitz matrix: ``y = x @ T`` == ``filter(b, 1, x)``.

    ``T[m, n] = taps[n - m]`` for ``0 <= n - m < len(taps)``.
    """
    t = np.zeros((n_in, n_in), dtype=np.complex128)
    b = np.asarray(taps, dtype=np.float64)
    for d in range(min(len(b), n_in)):
        idx = np.arange(n_in - d)
        t[idx, idx + d] = b[d]
    return t


def fused_pc_rdm_plain(
    echo: torch.Tensor, m_re: torch.Tensor, m_im: torch.Tensor,
    w_re: torch.Tensor, w_im: torch.Tensor,
) -> torch.Tensor:
    """Plain version: ``|W @ (echo @ M)|`` with complex64 matmuls."""
    p = torch.matmul(echo, torch.complex(m_re, m_im))
    return torch.matmul(torch.complex(w_re, w_im), p).abs()


def fused_pc_rdm(
    echo: torch.Tensor, m_re: torch.Tensor, m_im: torch.Tensor,
    w_re: torch.Tensor, w_im: torch.Tensor,
) -> torch.Tensor:
    """Echo (..., n_prt, n_in) complex64 -> (..., n_fft, n_out) float32 RDM.

    ``m_re``/``m_im`` are the (n_in, n_out) PC operator planes and
    ``w_re``/``w_im`` the (n_fft, n_prt) DFT planes.  CPU tensor:
    :func:`fused_pc_rdm_plain`.  CUDA tensor: the kernel, or an exception;
    ``fused_pc_rdm.launches`` counts the kernel launches.
    """
    if echo.dim() < 2:
        raise ValueError(f"fused_pc_rdm: echo must be (..., n_prt, n_in), got {tuple(echo.shape)}")
    n_prt, n_in = echo.shape[-2], echo.shape[-1]
    n_out, n_fft = m_re.shape[-1], w_re.shape[0]
    if m_re.shape != (n_in, n_out) or m_im.shape != m_re.shape:
        raise ValueError(
            f"fused_pc_rdm: PC planes {tuple(m_re.shape)}/{tuple(m_im.shape)} do not "
            f"match {n_in} fast-time samples"
        )
    if w_re.shape != (n_fft, n_prt) or w_im.shape != w_re.shape:
        raise ValueError(
            f"fused_pc_rdm: DFT planes {tuple(w_re.shape)}/{tuple(w_im.shape)} do not "
            f"match {n_prt} pulses"
        )
    if echo.device.type == "cpu":
        return fused_pc_rdm_plain(echo, m_re, m_im, w_re, w_im)
    if echo.device.type != "cuda":
        raise ValueError(f"fused_pc_rdm: unsupported device {echo.device}")
    if echo.dtype != torch.complex64 or echo.stride(-1) != 1 or echo.stride(-2) < n_in:
        raise ValueError(
            f"fused_pc_rdm: echo must be complex64 with unit fast-time stride and "
            f"non-overlapping rows, got {echo.dtype} with strides {echo.stride()}"
        )
    for name, t in (("m_re", m_re), ("m_im", m_im), ("w_re", w_re), ("w_im", w_im)):
        if t.dtype != torch.float32 or t.device != echo.device or not t.is_contiguous():
            raise ValueError(
                f"fused_pc_rdm: {name} must be a contiguous float32 tensor on "
                f"{echo.device}, got {t.dtype} on {t.device}"
            )
    try:  # the leading axes must merge into one batch axis without a copy
        x3 = echo.view(-1, n_prt, n_in)
    except RuntimeError as err:
        raise ValueError(
            f"fused_pc_rdm: echo {tuple(echo.shape)} with strides {echo.stride()} has "
            "leading axes that do not merge into one batch axis"
        ) from err
    batch_shape = echo.shape[:-2]
    batch = math.prod(batch_shape)
    if not 0 < batch <= 65535:
        raise ValueError(f"fused_pc_rdm: batch {batch} outside 1..65535")
    if min(n_prt, n_in, n_out, n_fft) < 1:
        raise ValueError(f"fused_pc_rdm: empty geometry {(n_prt, n_in, n_out, n_fft)}")
    lib = _build.library()
    sms = torch.cuda.get_device_properties(echo.device).multi_processor_count
    smem = lib.rsp_fused_pc_rdm_smem_bytes(n_prt, n_out, batch, sms)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_pc_rdm: a {n_prt}-pulse P slice needs {smem} B of shared memory "
            f"per block (> {SMEM_LIMIT})"
        )
    # 16-byte copies: 2 samples of an X row, 4 pulses of a W row
    x_vec = int(x3.data_ptr() % 16 == 0 and x3.stride(0) % 2 == 0 and x3.stride(1) % 2 == 0)
    w_vec = int(n_prt % 4 == 0 and w_re.data_ptr() % 16 == 0 and w_im.data_ptr() % 16 == 0)
    out = torch.empty(batch_shape + (n_fft, n_out), dtype=torch.float32, device=echo.device)
    stream = torch.cuda.current_stream(echo.device).cuda_stream
    rc = lib.rsp_fused_pc_rdm(
        x3.data_ptr(), x3.stride(0), x3.stride(1), m_re.data_ptr(), m_im.data_ptr(),
        w_re.data_ptr(), w_im.data_ptr(), out.data_ptr(),
        batch, n_prt, n_in, n_out, n_fft, sms, x_vec, w_vec, stream,
    )
    _build.check(rc, "rsp_fused_pc_rdm")
    fused_pc_rdm.launches += 1
    return out


fused_pc_rdm.launches = 0

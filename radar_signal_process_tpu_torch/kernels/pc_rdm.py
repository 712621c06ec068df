"""B3: fused pulse compression + windowed Doppler DFT + magnitude.

Replaces ``radar_signal_process_tpu/kernels/pc_rdm_pallas.py::
fused_pc_rdm_pallas``.  ``out = |W . (X . M)|``: M is the per-row pulse
compression operator built on the host in float64
(:func:`pc_matrix_freq_domain` for the G0 long pulse's 512-point matched
filter, :func:`pc_matrix_fir` for the short pulse's raw-tap FIR), W the
windowed, zero-padded (n_fft, n_prt) DFT plane (``kernels.rdm.dft_planes``),
both held as float32 re/im planes as the Pallas wrapper casts them.

On a CUDA tensor :func:`fused_pc_rdm` launches ``csrc/pc_rdm.cu``: both
products run on Hopper's ``wgmma`` at FP32 accuracy (3xTF32, the complex
operand split in registers as the A operand), staged by TMA through an
mbarrier ring.  Phase 1 forms ``P = X . M`` against M's pre-split image
(:func:`pc_operator_image`, made once per operator and kept, keyed on the
planes' storage, shape and version) and writes P, split, as the image phase
2 reads; phase 2 forms ``|W . P|`` with W's raw planes split in registers.
A G0 frame is ~35 GFLOP of that work, so it is bound by arithmetic.  The
echo is read in place (unit fast-time stride, any row stride), so the pulse
segments of a beam need no copy.  On a CPU tensor it runs
:func:`fused_pc_rdm_plain`, two complex64 matmuls and ``abs``.
"""

from __future__ import annotations

import collections
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.kernels.rdm import _tf32_split

# csrc/pc_rdm.cu's tiling: output columns a tile (the wgmma's N is twice it:
# re then im), K (samples, pulses) a stage of its ring, and the K its
# tensor-core partials sum before they are added into FP32 totals
TILE_COLS, STAGE_K = 48, 16
PARTIAL_K = 2 * STAGE_K
IMAGE_STAGE_FLOATS = 2 * 3 * TILE_COLS * STAGE_K
_IMAGE_CACHE = 8  # operator images kept (G0Chain holds two operators)
_images: collections.OrderedDict = collections.OrderedDict()
_images_lock = threading.Lock()


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


def wgmma_b_image_plain(b_re: torch.Tensor, b_im: torch.Tensor) -> torch.Tensor:
    """The B operand image of ``csrc/pc_rdm.cu`` for a complex operand whose
    rows (the product's output columns) are ``b_re + i b_im`` (N, K), K
    contiguous: over each tile of TILE_COLS rows and each stage of STAGE_K,
    the sub-planes ``-b_im, b_re, b_im`` split into TF32 hi/lo, zero-padded
    to whole tiles and stages, in the kernel's shared-memory image
    ``[tile][stage][part][sub][n // 8][k // 4][n % 8][k % 4]`` with parts
    hi, lo, ``n < TILE_COLS``, ``k < STAGE_K`` (8-row x 4-value core
    matrices, 128 bytes each)."""
    n, k = b_re.shape
    tiles, stages = -(-n // TILE_COLS), -(-k // STAGE_K)
    pad = (0, stages * STAGE_K - k, 0, tiles * TILE_COLS - n)
    sub = torch.stack([F.pad(-b_im, pad), F.pad(b_re, pad), F.pad(b_im, pad)])
    parts = torch.stack(_tf32_split(sub))  # (part, sub, rows, K)
    parts = parts.view(2, 3, tiles, TILE_COLS // 8, 8, stages, STAGE_K // 4, 4)
    return parts.permute(2, 5, 0, 1, 3, 6, 4, 7).contiguous()


def pc_operator_image_plain(m_re: torch.Tensor, m_im: torch.Tensor) -> torch.Tensor:
    """Plain version of M's image: :func:`wgmma_b_image_plain` of M^T (rows
    are the n_out output columns, K the n_in samples)."""
    return wgmma_b_image_plain(m_re.t(), m_im.t())


def pc_operator_image(m_re: torch.Tensor, m_im: torch.Tensor) -> torch.Tensor:
    """M's image, which :func:`fused_pc_rdm` prepares once per operator: CPU
    tensors get :func:`pc_operator_image_plain`, CUDA tensors the split
    kernel of ``csrc/pc_rdm.cu`` (bit for bit the same image).  Counts no
    launch."""
    if m_re.shape != m_im.shape or m_re.dim() != 2:
        raise ValueError(f"PC planes {tuple(m_re.shape)}/{tuple(m_im.shape)} differ or are not 2-D")
    if m_re.device.type == "cpu":
        return pc_operator_image_plain(m_re, m_im)
    _check_planes_cuda(m_re.device, (("m_re", m_re), ("m_im", m_im)))
    n_in, n_out = m_re.shape
    img = torch.empty((-(-n_out // TILE_COLS), -(-n_in // STAGE_K), 2, 3, TILE_COLS // 8,
                       STAGE_K // 4, 8, 4), dtype=torch.float32, device=m_re.device)
    rc = _build.library().rsp_fused_pc_rdm_split_m(
        m_re.data_ptr(), m_im.data_ptr(), img.data_ptr(), img.numel(), n_in, n_out,
        torch.cuda.current_stream(m_re.device).cuda_stream,
    )
    _build.check(rc, "rsp_fused_pc_rdm_split_m")
    return img


def prepared_operator_image(m_re: torch.Tensor, m_im: torch.Tensor) -> torch.Tensor:
    """:func:`pc_operator_image`, kept across calls: keyed on both planes'
    ``data_ptr``, shape and device, and made again when either plane's
    ``_version`` has moved (an in-place edit).  An entry holds the planes
    themselves, so their storage cannot be freed and reused by other planes
    while the entry lives; the last ``_IMAGE_CACHE`` operators are kept."""
    key = (m_re.data_ptr(), m_im.data_ptr(), tuple(m_re.shape), str(m_re.device))
    version = (m_re._version, m_im._version)
    with _images_lock:
        hit = _images.get(key)
        if hit is not None and hit[2] == version:
            _images.move_to_end(key)
            return hit[3]
        img = pc_operator_image(m_re, m_im)
        _images[key] = (m_re, m_im, version, img)
        _images.move_to_end(key)
        while len(_images) > _IMAGE_CACHE:
            _images.popitem(last=False)
        return img


def _check_planes_cuda(device: torch.device, tensors) -> None:
    for name, t in tensors:
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"fused_pc_rdm: {name} must be a contiguous float32 tensor on "
                f"{device}, got {t.dtype} on {t.device}"
            )


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
    _check_planes_cuda(echo.device, (("m_re", m_re), ("m_im", m_im), ("w_re", w_re),
                                     ("w_im", w_im)))
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
    if -(-batch * n_out // TILE_COLS) > 65535:
        raise ValueError(f"fused_pc_rdm: {batch} x {n_out} output columns exceed the grid")
    lib = _build.library()
    smem = lib.rsp_fused_pc_rdm_smem_bytes()
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"fused_pc_rdm: a block needs {smem} B of shared memory (> {_build.SMEM_LIMIT})"
        )
    m_img = prepared_operator_image(m_re, m_im)
    p_img = torch.empty((-(-batch * n_out // TILE_COLS), -(-n_prt // STAGE_K),
                         IMAGE_STAGE_FLOATS), dtype=torch.float32, device=echo.device)
    ldx = x3.stride(1)
    sb = x3.stride(0) if batch > 1 else n_prt * ldx
    # TMA boxes: X 16-byte aligned with even strides, rows of a beam not
    # overlapping the next; W rows whole 16 bytes
    x_tma = int(x3.data_ptr() % 16 == 0 and ldx % 2 == 0 and sb % 2 == 0 and sb >= n_prt * ldx)
    w_tma = int(n_prt % 4 == 0 and w_re.data_ptr() % 16 == 0 and w_im.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(echo.device).multi_processor_count
    out = torch.empty(batch_shape + (n_fft, n_out), dtype=torch.float32, device=echo.device)
    stream = torch.cuda.current_stream(echo.device).cuda_stream
    rc = lib.rsp_fused_pc_rdm(
        x3.data_ptr(), sb, ldx, m_img.data_ptr(), m_img.numel(), w_re.data_ptr(),
        w_im.data_ptr(), p_img.data_ptr(), p_img.numel(), out.data_ptr(),
        batch, n_prt, n_in, n_out, n_fft, sms, x_tma, w_tma, stream,
    )
    _build.check(rc, "rsp_fused_pc_rdm")
    fused_pc_rdm.launches += 1
    return out


fused_pc_rdm.launches = 0

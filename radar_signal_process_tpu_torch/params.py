"""The chains' constants as tensors.

The JAX package takes numpy arrays (reference pulses, DBF coefficients, an
iSTC curve, a matched-filter waveform) and derives its constants inside
jitted functions or ``G0Chain.__init__``.  The port derives them once here,
in float64 on the host exactly as the JAX package does, casts them to
complex64/float32 and places them on the chain's device; ``FrameProcessor``,
``G1ValidationChain`` and ``G0Chain`` hold them as buffers, and
``mtd_produce`` takes them from :func:`cpi_params`.  The parity tests hand
the same numpy arrays to both packages through this.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import (
    NARROW_PULSE_FIR_TAPS,
    G0ChainConfig,
    RadarProfile,
)
from radar_signal_process_tpu_torch.device import COMPLEX, REAL
from radar_signal_process_tpu_torch.kernels.pc_rdm import pc_matrix_fir, pc_matrix_freq_domain
from radar_signal_process_tpu_torch.kernels.rdm import dft_planes
from radar_signal_process_tpu_torch.ops.mtd import stc_gain
from radar_signal_process_tpu_torch.ops.pulse_compression import segment_filters
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch.ops.windows import make_window


@dataclasses.dataclass(frozen=True)
class ChainParams:
    window: torch.Tensor                    # (n_prt,) f32 slow-time taper
    dft_re: torch.Tensor                    # (n_fft, n_prt) f32 DFT plane, real
    dft_im: torch.Tensor                    # (n_fft, n_prt) f32 DFT plane, imag
    pc_spectra: Tuple[torch.Tensor, ...]    # per pulse segment, complex64
    pc_filter_lens: Tuple[int, ...]         # filter length per segment
    dbf: Optional[torch.Tensor]             # (n_beams, n_channels) complex64
    stc_gain: Optional[torch.Tensor]        # (point_prt,) f32 iSTC gain


def chain_params(
    profile: RadarProfile,
    dbf_coeffs: np.ndarray | None = None,
    pulses=None,
    stc_curve_db: np.ndarray | None = None,
    device: str | torch.device = "cpu",
    n_pulses: int | None = None,
) -> ChainParams:
    """Constants of the G2 chain for ``profile`` on ``device``.

    ``pulses`` overrides the synthesized reference pulses; ``stc_curve_db``
    is used when ``profile.mtd.istc`` is set.  The slow-time window and the
    DFT planes span ``n_pulses`` (default: one frame's PRTs).
    """
    n = n_pulses or profile.prt_per_frame
    n_fft = profile.mtd.fft_length or n
    window = make_window(profile.mtd.window, n, profile.mtd.window_beta)
    w_re, w_im = dft_planes(window, n_fft, profile.mtd.fftshift)
    pulses = reference_pulses(profile) if pulses is None else pulses
    spectra, lens = segment_filters(profile, pulses)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    use_stc = profile.mtd.istc and stc_curve_db is not None
    return ChainParams(
        window=t(window, REAL),
        dft_re=t(w_re, REAL),
        dft_im=t(w_im, REAL),
        pc_spectra=tuple(t(s, COMPLEX) for s in spectra),
        pc_filter_lens=lens,
        dbf=None if dbf_coeffs is None else t(dbf_coeffs, COMPLEX),
        stc_gain=t(stc_gain(stc_curve_db, profile.point_prt), REAL) if use_stc else None,
    )


@functools.lru_cache(maxsize=16)
def cpi_params(profile: RadarProfile, n_pulses: int, device: torch.device) -> ChainParams:
    """:func:`chain_params` of one CPI of ``n_pulses`` with the synthesized
    reference pulses, built once per (profile, n_pulses, device)."""
    return chain_params(profile, device=device, n_pulses=n_pulses)


@dataclasses.dataclass(frozen=True)
class G0Params:
    """Constants of the G0 chain (``G0Chain.__init__``, ``g0_chain.py:117-181``)."""

    match_spec: torch.Tensor     # (pc_fft,) complex64 long-pulse matched filter
    pc_long_re: torch.Tensor     # (point_long, pc_fft) f32 PC operator, real
    pc_long_im: torch.Tensor     # (point_long, pc_fft) f32 PC operator, imag
    pc_short_re: torch.Tensor    # (point_short, point_short) f32 raw-FIR Toeplitz
    pc_short_im: torch.Tensor    # (point_short, point_short) f32 (zero)
    mtd_window: torch.Tensor     # (prt_per_frame,) f32 slow-time window
    dft_re: torch.Tensor         # (mtd_fft, prt_per_frame) f32 unshifted DFT plane
    dft_im: torch.Tensor
    r_scale_short: torch.Tensor  # (point_short,) f32 range of each cell [m]
    r_scale_long: torch.Tensor   # (pc_fft,) f32


def g0_chain_params(
    profile: RadarProfile,
    chain_cfg: G0ChainConfig = G0ChainConfig(),
    match_waveform: np.ndarray | None = None,
    power_norm: bool = True,
    device: str | torch.device = "cpu",
) -> G0Params:
    """Constants of the G0 chain for ``profile`` on ``device``.

    ``match_waveform`` overrides the LFM reference of the long pulse
    (``exp(j*pi*K2*t^2)``, ``DMX_SignalProcessing_main_xzr.m:161-162``);
    ``power_norm`` divides it by its norm (``:166``).
    """
    tau2 = profile.pulse_widths[1]
    if match_waveform is None:
        n2 = int(round(tau2 / profile.ts))
        t2 = np.arange(n2) * profile.ts - tau2 / 2.0
        match_waveform = np.exp(1j * np.pi * (profile.bandwidth / tau2) * t2**2)
    if power_norm:
        match_waveform = match_waveform / np.linalg.norm(match_waveform)
    win = make_window(chain_cfg.pc_window, len(match_waveform), chain_cfg.pc_window_beta)
    # peak at the pulse's leading edge (:202)
    match_spec = np.conj(np.fft.fft(match_waveform * win, chain_cfg.pc_fft_length))
    mtd_window = make_window(
        chain_cfg.mtd_window, profile.prt_per_frame, chain_cfg.mtd_window_beta
    )
    point_short = profile.segment_points[0]
    point_long = profile.point_prt - point_short
    pc_long = pc_matrix_freq_domain(match_spec, point_long, chain_cfg.pc_fft_length)
    pc_short = pc_matrix_fir(np.asarray(NARROW_PULSE_FIR_TAPS), point_short)
    w_re, w_im = dft_planes(mtd_window, chain_cfg.mtd_fft_length, shift=False)
    r_scale_short = (
        np.arange(point_short) * profile.delta_r
        + chain_cfg.r_sys_err_short - chain_cfg.r_measure_err_short
    )
    r_scale_long = (
        np.arange(chain_cfg.pc_fft_length) * profile.delta_r
        + chain_cfg.r_sys_err_long - chain_cfg.r_measure_err_long
    )

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return G0Params(
        match_spec=t(match_spec, COMPLEX),
        pc_long_re=t(pc_long.real, REAL),
        pc_long_im=t(pc_long.imag, REAL),
        pc_short_re=t(pc_short.real, REAL),
        pc_short_im=t(pc_short.imag, REAL),
        mtd_window=t(mtd_window, REAL),
        dft_re=t(w_re, REAL),
        dft_im=t(w_im, REAL),
        r_scale_short=t(r_scale_short, REAL),
        r_scale_long=t(r_scale_long, REAL),
    )

"""MTD pipeline: segmented pulse compression -> (CPI slicing) -> RDM former.

Port of ``radar_signal_process_tpu/models/mtd_pipeline.py``.
:func:`mtd_produce` is one CPI of any pulse count, the whole
``fun_MTD_produce`` chain (``MTD/fun_MTD_produce.m:86-102``).
:class:`FrameProcessor` is the G2 windowed form: two consecutive frames are
concatenated along slow time to double the CPI, each PRT row is compressed
once, and ``win_size`` overlapping slices per beam go through the RDM former
(``MTD/main_produce_dataset_win_xzr_v2.m:75-136``).  Leading axes (beams,
slices, frames) are batch axes of every op, and the RDM former is the B2
kernel for shifted and unshifted spectra alike.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from radar_signal_process_tpu_torch.config import RadarProfile, matlab_round
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.kernels.rdm import doppler_rdm
from radar_signal_process_tpu_torch.ops.mtd import (
    istc_compensate,
    mti_cancel,
    notch_rows,
    stc_gain,
)
from radar_signal_process_tpu_torch.ops.pulse_compression import (
    segmented_pulse_compression,
)
from radar_signal_process_tpu_torch.params import ChainParams, chain_params, cpi_params


def window_slice_starts(prts_per_slice: int, win_size: int) -> Tuple[int, ...]:
    """Slice start rows: ``round(i * prts / win_size)`` 0-based
    (``main_produce_dataset_win_xzr_v2.m:123``)."""
    return tuple(
        matlab_round(i * prts_per_slice / win_size) for i in range(win_size)
    )


def slice_cpi_window(echo_win: torch.Tensor, win_size: int) -> torch.Tensor:
    """(..., 2*n_prt, n_pts) window -> (..., win_size, n_prt, n_pts)."""
    prts = echo_win.shape[-2] // 2
    starts = window_slice_starts(prts, win_size)
    return torch.stack([echo_win[..., s : s + prts, :] for s in starts], dim=-3)


def _form_rdm(pc: torch.Tensor, profile: RadarProfile, params) -> torch.Tensor:
    """Compressed pulses (..., n_pulses, n_pts) -> notched magnitude RDM
    (B2 with the DFT planes of ``params``; no notch when the profile's
    divisor is 0)."""
    n_fft = profile.mtd.fft_length or pc.shape[-2]
    notch = notch_rows(n_fft, profile.mtd.notch_divisor)
    return doppler_rdm(pc, params.dft_re, params.dft_im, notch)


def mtd_produce(
    echo: torch.Tensor, profile: RadarProfile, stc_curve_db=None, pulses=None
) -> torch.Tensor:
    """Echo (..., n_pulses, point_prt) complex64 -> magnitude RDM
    (..., n_fft, point_prt) on the echo's device.

    The window and the DFT planes span the echo's pulse count.  The
    reference's dormant hooks are profile options: iSTC gain before
    compression (``fun_MTD_produce.m:80-81``, with ``stc_curve_db``) and the
    MTI canceller before the Doppler transform (``fun_Process_MTI.m``).
    ``pulses`` overrides the synthesized matched-filter waveforms.
    """
    n = echo.shape[-2]
    if pulses is None:
        params = cpi_params(profile, n, echo.device)
    else:
        params = chain_params(profile, pulses=pulses, device=echo.device, n_pulses=n)
    if profile.mtd.istc and stc_curve_db is not None:
        gain = torch.as_tensor(stc_gain(stc_curve_db, echo.shape[-1]), device=echo.device)
        echo = istc_compensate(echo, gain)
    pc = segmented_pulse_compression(echo, profile, params.pc_spectra, params.pc_filter_lens)
    if profile.mtd.mti_lag:
        pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
    return _form_rdm(pc, profile, params)


def mtd_window_produce(
    echo_win: torch.Tensor, profile: RadarProfile, params, win_size: int = 4
) -> torch.Tensor:
    """Doubled-CPI window (..., 2*n_prt, n_pts) -> (..., win_size, n_prt, n_pts) RDMs.

    Pulse compression (and iSTC) run per PRT row, so they run once on the
    doubled window before slicing; MTI, the Doppler transform and the notch
    stay per slice.  ``params`` is a :class:`ChainParams` or a module
    holding the same buffers (:class:`FrameProcessor`).
    """
    if profile.mtd.istc and params.stc_gain is not None:
        echo_win = istc_compensate(echo_win, params.stc_gain)
    pc_win = segmented_pulse_compression(
        echo_win, profile, params.pc_spectra, params.pc_filter_lens
    )
    pc = slice_cpi_window(pc_win, win_size)
    if profile.mtd.mti_lag:
        pc = mti_cancel(pc, lag=profile.mtd.mti_lag)
    return _form_rdm(pc, profile, params)


class FrameProcessor(nn.Module):
    """One frame pair -> RDM stack.

    ``forward(frame_now, frame_next)`` maps two (n_beams, n_prt, point_prt)
    complex64 frames to the (n_beams, win_size, n_prt, point_prt) float32
    RDM stack (``main_produce_dataset_win_xzr_v2.m:109-148``).  The window,
    the DFT plane, the pulse-compression spectra and the iSTC gain are
    buffers.
    """

    def __init__(self, profile: RadarProfile, params: ChainParams, win_size: int = 4):
        super().__init__()
        self.profile = profile
        self.win_size = win_size
        self.pc_filter_lens = params.pc_filter_lens
        self.register_buffer("window", params.window)
        self.register_buffer("dft_re", params.dft_re)
        self.register_buffer("dft_im", params.dft_im)
        for i, s in enumerate(params.pc_spectra):
            self.register_buffer(f"pc_spectrum_{i}", s)
        self.register_buffer("stc_gain", params.stc_gain)

    @property
    def pc_spectra(self) -> Tuple[torch.Tensor, ...]:
        return tuple(
            getattr(self, f"pc_spectrum_{i}") for i in range(len(self.pc_filter_lens))
        )

    def forward(self, frame_now: torch.Tensor, frame_next: torch.Tensor) -> torch.Tensor:
        window = torch.cat([frame_now, frame_next], dim=-2)
        return mtd_window_produce(window, self.profile, self, self.win_size)


def make_frame_processor(
    profile: RadarProfile,
    win_size: int = 4,
    stc_curve_db=None,
    pulses=None,
    device: str | torch.device = "cuda",
) -> FrameProcessor:
    """:class:`FrameProcessor` for ``profile`` with its buffers on ``device``
    (the card unless the caller asks for the CPU; a CUDA device that is
    absent raises)."""
    params = chain_params(
        profile, pulses=pulses, stc_curve_db=stc_curve_db, device=resolve_device(device)
    )
    return FrameProcessor(profile, params, win_size)

"""The chain's constants as tensors.

The JAX package takes numpy arrays (reference pulses, DBF coefficients, an
iSTC curve) and derives its constants inside jitted functions.  The port
derives them once here, in float64 on the host exactly as the JAX package
does, casts them to complex64/float32 and places them on the chain's
device; ``FrameProcessor`` and ``Detector`` hold them as buffers.  The
parity tests hand the same numpy arrays to both packages through this.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import RadarProfile
from radar_signal_process_tpu_torch.device import COMPLEX, REAL
from radar_signal_process_tpu_torch.kernels.rdm import dft_planes
from radar_signal_process_tpu_torch.ops.mtd import notch_mask, stc_gain
from radar_signal_process_tpu_torch.ops.pulse_compression import segment_filters
from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch.ops.windows import make_window

# the detector's CFAR-stage re-notch, N/20 rows (CFAR_WangCai/fun_0v_pressing.m)
RENOTCH_DIVISOR = 20


@dataclasses.dataclass(frozen=True)
class ChainParams:
    window: torch.Tensor                    # (n_prt,) f32 slow-time taper
    dft_re: torch.Tensor                    # (n_fft, n_prt) f32 DFT plane, real
    dft_im: torch.Tensor                    # (n_fft, n_prt) f32 DFT plane, imag
    pc_spectra: Tuple[torch.Tensor, ...]    # per pulse segment, complex64
    pc_filter_lens: Tuple[int, ...]         # filter length per segment
    renotch_mask: torch.Tensor              # (n_fft,) f32 CFAR-stage notch
    dbf: Optional[torch.Tensor]             # (n_beams, n_channels) complex64
    stc_gain: Optional[torch.Tensor]        # (point_prt,) f32 iSTC gain


def chain_params(
    profile: RadarProfile,
    dbf_coeffs: np.ndarray | None = None,
    pulses=None,
    stc_curve_db: np.ndarray | None = None,
    device: str | torch.device = "cpu",
) -> ChainParams:
    """Constants of the G2 chain for ``profile`` on ``device``.

    ``pulses`` overrides the synthesized reference pulses; ``stc_curve_db``
    is used when ``profile.mtd.istc`` is set.
    """
    n = profile.prt_per_frame
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
        renotch_mask=t(notch_mask(n_fft, RENOTCH_DIVISOR), REAL),
        dbf=None if dbf_coeffs is None else t(dbf_coeffs, COMPLEX),
        stc_gain=t(stc_gain(stc_curve_db, profile.point_prt), REAL) if use_stc else None,
    )

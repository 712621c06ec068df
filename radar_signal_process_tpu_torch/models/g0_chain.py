"""G0 end-to-end chain: one dual-beam frame -> detections and measurements.

Port of ``radar_signal_process_tpu/models/g0_chain.py`` (after
``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m``).  Per frame:

* split each beam into the short / long pulse segments (:330-335);
* B3 per segment: raw-tap FIR (short, :343-344) or the 512-point
  frequency-domain matched filter (long, :346-353), then the
  Hamming-windowed, unshifted 2048-point slow-time DFT and the magnitude
  (:413-418), fused into one kernel (``kernels.pc_rdm``);
* monopulse sum |L|+|R| and difference |R|-|L| (:420-426);
* zero the low-velocity clutter rows of the unshifted spectrum (:462-465);
* B1, the cascaded 2-D CFAR, over each segment's sum RDM (:468-472);
* the 32 strongest hits, and their sub-bin range / velocity and monopulse
  elevation (:489-516).

On a CUDA device the front runs B3 and the CFAR runs B1, and nothing else;
on the CPU both run their plain versions.  The JAX class's ``use_split`` /
``_front`` / ``_finish`` split works around XLA on the CPU and has no
counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from radar_signal_process_tpu_torch.config import (
    G0_PROFILE,
    G0ChainConfig,
    NARROW_PULSE_FIR_TAPS,
    RadarProfile,
)
from radar_signal_process_tpu_torch.device import COMPLEX, REAL, resolve_device
from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
from radar_signal_process_tpu_torch.kernels.pc_rdm import fused_pc_rdm
from radar_signal_process_tpu_torch.ops.measure import (
    DetectionList,
    Measurements,
    extract_detections,
    motion_parameters,
)
from radar_signal_process_tpu_torch.ops.mtd import doppler_process, zero_velocity_notch_unshifted
from radar_signal_process_tpu_torch.ops.pulse_compression import (
    fir_compress,
    fir_spectrum,
    fixed_length_matched_filter,
)
from radar_signal_process_tpu_torch.ops.tables import angle_k_values, freq_value
from radar_signal_process_tpu_torch.params import g0_chain_params
from radar_signal_process_tpu_torch.utils.profiling import span

C_LIGHT = 299792458.0


class G0FrameParams(NamedTuple):
    """Frequency/beam-dependent quantities of one frame (:310-327,506-516)."""

    v_scale: torch.Tensor  # (mtd_fft,) f32 velocity scale, sign-inverted
    delta_v: float         # m/s per Doppler bin
    k_value: float         # monopulse slope K(freq, beam)
    beam_pos: int


class G0FrameResult(NamedTuple):
    rdm_sum_short: torch.Tensor    # (mtd_fft, point_short)
    rdm_sum_long: torch.Tensor     # (mtd_fft, pc_fft)
    rdm_diff_short: torch.Tensor
    rdm_diff_long: torch.Tensor
    flags_short: torch.Tensor
    flags_long: torch.Tensor
    vflags_short: torch.Tensor
    vflags_long: torch.Tensor
    detections_short: DetectionList
    detections_long: DetectionList
    measurements_short: Measurements
    measurements_long: Measurements


class G0Chain(nn.Module):
    """G0 per-frame processor with its constants as buffers on ``device``
    (the card unless the caller asks for the CPU; a CUDA device that is
    absent raises).

    ``freq_index``/``beam_pos`` are the defaults; :meth:`process_frame`
    takes per-frame values (parsed from each frame's header), so a
    frequency-hopping capture gets per-frame velocity scales and monopulse
    slopes.
    """

    def __init__(
        self,
        profile: RadarProfile = G0_PROFILE,
        chain: G0ChainConfig = G0ChainConfig(),
        freq_index: int = 5,
        beam_pos: int = 0,
        match_waveform: np.ndarray | None = None,
        power_norm: bool = True,
        max_detections: int = 32,
        spectral_width_db: float | None = None,
        spectral_width_interp: int = 1,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.profile = profile
        self.chain = chain
        self.freq_index = freq_index
        self.beam_pos = beam_pos
        self.max_detections = max_detections
        self.spectral_width_db = spectral_width_db
        self.spectral_width_interp = spectral_width_interp
        self.device = resolve_device(device)
        params = g0_chain_params(profile, chain, match_waveform, power_norm, device=self.device)
        for name, value in vars(params).items():
            self.register_buffer(name, value)

        self.wavelength = C_LIGHT / freq_value(freq_index)  # lamda = c/fc (:315)
        self._delta_doppler = profile.prf / chain.mtd_fft_length
        self._f_scale = np.fft.fftshift(
            np.arange(-chain.mtd_fft_length // 2, chain.mtd_fft_length // 2)
            * self._delta_doppler
        )
        self._params_cache: dict = {}
        fp, self.n_clutter = self.frame_params(freq_index, beam_pos)
        self.delta_v = fp.delta_v
        self.k_value = fp.k_value

    def frame_params(self, freq_index: int, beam_pos: int) -> tuple[G0FrameParams, int]:
        """Frequency/beam-dependent scalars of one frame and its clutter-row
        count, computed on the host in float64 as the reference does in its
        frame loop (:310-327,506-516)."""
        key = (int(freq_index), int(beam_pos))
        hit = self._params_cache.get(key)
        if hit is not None:
            return hit
        table = angle_k_values(self.chain.sys_num)
        n_freq, n_beam = table.shape
        if not (0 <= key[0] < n_freq and 0 <= key[1] < n_beam):
            # agile mode feeds header fields here: a corrupt header must fail
            # loud, not wrap into the wrong table row
            raise ValueError(
                f"freq_index/beam_pos ({key[0]}, {key[1]}) outside the "
                f"calibration tables ({n_freq} x {n_beam}); corrupt frame "
                "header? pin --freq-index/--beam-pos to override"
            )
        wavelength = C_LIGHT / freq_value(key[0])
        delta_v = wavelength * self._delta_doppler / 2.0
        n_clutter = int(math.floor(self.chain.mtd_clutter_v / delta_v))
        v_scale = -wavelength * self._f_scale / 2.0  # (:326-327)
        params = G0FrameParams(
            v_scale=torch.as_tensor(v_scale, dtype=REAL, device=self.device),
            delta_v=float(delta_v),
            k_value=float(table[key[0], key[1]]),
            beam_pos=key[1],
        )
        self._params_cache[key] = (params, n_clutter)
        return params, n_clutter

    def compensate_angle(self, angle_code: np.ndarray) -> np.ndarray:
        """North-angle compensation: rem(angle + northAngle + angleE1, 360) (:310)."""
        return np.remainder(angle_code + self.chain.north_angle + self.chain.angle_e1, 360.0)

    # ------------------------------------------------------------------ core
    def beams(self, left, right) -> torch.Tensor:
        """(2, prt, point_prt) complex64 stack of the two beams on the device."""
        def one(x):
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.asarray(x, dtype=np.complex64))
            with span("g0.h2d", "copy", x.numel() * x.element_size()):
                return x.to(self.device, COMPLEX)

        return torch.stack([one(left), one(right)])

    def front(self, beams: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """B3 on each segment: per-beam |RDM| (2, mtd_fft, n) of the short and
        long pulse.  The segments are read in place from ``beams``."""
        ps = self.profile.segment_points[0]
        abs_short = fused_pc_rdm(beams[..., :ps], self.pc_short_re, self.pc_short_im,
                                 self.dft_re, self.dft_im)
        abs_long = fused_pc_rdm(beams[..., ps:], self.pc_long_re, self.pc_long_im,
                                self.dft_re, self.dft_im)
        return abs_short, abs_long

    def pc(self, beams: torch.Tensor, segments=("short", "long")) -> tuple[torch.Tensor, ...]:
        """The FFT form of the pulse compression (the JAX ``_pc``): raw-tap FIR
        on the short segment, 512-point matched filter on the long one; the
        compressed ``segments``, in that order."""
        ps = self.profile.segment_points[0]
        out = []
        for segment in segments:
            if segment == "short":
                spec = torch.as_tensor(fir_spectrum(ps, normalize=False), dtype=COMPLEX,
                                       device=beams.device)
                out.append(fir_compress(beams[..., :ps], spec, len(NARROW_PULSE_FIR_TAPS),
                                        post_scale=1.0, roll_group_delay=False))
            else:
                out.append(fixed_length_matched_filter(beams[..., ps:], self.match_spec))
        return tuple(out)

    def front_fft(self, beams: torch.Tensor, segments=("short", "long")) -> tuple[torch.Tensor, ...]:
        """B3's cuFFT form: :meth:`pc`, then the windowed, unshifted,
        zero-padded slow-time FFT and the magnitude (``ops.mtd``)."""
        window = self.mtd_window.double().cpu().numpy()
        n_fft = self.chain.mtd_fft_length
        return tuple(doppler_process(mf, window, n_fft, shift=False)
                     for mf in self.pc(beams, segments))

    def process_frame(
        self, left, right, freq_index: int | None = None, beam_pos: int | None = None
    ) -> G0FrameResult:
        """One frame: ``left``/``right`` (prt_per_frame, point_prt) complex.

        ``freq_index``/``beam_pos`` default to the chain's; pass the frame's
        own parsed ``freInd``/``beamPosNum`` for per-frame agility.
        """
        with span("g0.params", "launch"):
            params, n_clutter = self.frame_params(
                self.freq_index if freq_index is None else freq_index,
                self.beam_pos if beam_pos is None else beam_pos,
            )
        beams = self.beams(left, right)
        with span("g0.front", "launch"):
            abs_short, abs_long = self.front(beams)
        del beams             # the stack is let go once B3 has been enqueued
        with span("g0.combine", "launch"):
            sum_short = zero_velocity_notch_unshifted(abs_short[0] + abs_short[1], n_clutter)
            sum_long = zero_velocity_notch_unshifted(abs_long[0] + abs_long[1], n_clutter)
            diff_short = abs_short[1] - abs_short[0]
            diff_long = abs_long[1] - abs_long[0]

        cfar = self.profile.cfar
        with span("g0.cfar", "launch"):
            flags_s, vflags_s = cascaded_cfar2d(sum_short, cfar, n_clutter)
            flags_l, vflags_l = cascaded_cfar2d(sum_long, cfar, n_clutter)
        with span("g0.extract", "launch"):
            dets_s = extract_detections(flags_s, sum_short, self.max_detections)
            dets_l = extract_detections(flags_l, sum_long, self.max_detections)

        chain = self.chain
        with span("g0.measure", "launch"):
            common = dict(
                delta_r=self.profile.delta_r,
                v_scale=params.v_scale,
                delta_v=params.delta_v,
                k_value=params.k_value,
                beam_pos=params.beam_pos,
                beam_angle_step=chain.beam_angle_step,
                n_clutter=n_clutter,
                extra_dots=chain.extra_dots,
                r_interp=chain.r_interp_times,
                v_interp=chain.v_interp_times,
                ele_angle_comp=chain.ele_angle_comp,
                ele_angle_sys_err=chain.ele_angle_sys_err,
                spectral_width_db=self.spectral_width_db,
                spectral_width_shifted=False,
                spectral_width_interp=self.spectral_width_interp,
            )
            meas_s = motion_parameters(sum_short, diff_short, dets_s,
                                       r_scale=self.r_scale_short, **common)
            meas_l = motion_parameters(sum_long, diff_long, dets_l,
                                       r_scale=self.r_scale_long, **common)
        return G0FrameResult(
            rdm_sum_short=sum_short, rdm_sum_long=sum_long,
            rdm_diff_short=diff_short, rdm_diff_long=diff_long,
            flags_short=flags_s, flags_long=flags_l,
            vflags_short=vflags_s, vflags_long=vflags_l,
            detections_short=dets_s, detections_long=dets_l,
            measurements_short=meas_s, measurements_long=meas_l,
        )

"""Pulse compression: matched filtering and narrow-pulse FIR compression.

Port of ``radar_signal_process_tpu/ops/pulse_compression.py`` with
``torch.fft`` (cuFFT on the card, pocketfft on the CPU).  Every op works on
the last axis of a batched complex64 tensor.  The filter spectra are host
constants built once in float64 (``segment_filters``) and held as module
buffers by the frame processor.

Replicated reference semantics (file:line):

* matched filter ``h = conj(fliplr(s0))``, linear convolution of length
  N+M-1 by FFT fast convolution — ``MTD/fun_pulse_compression.m:13-37``;
* the compressed segment is extracted from sample ``len(pulse)`` (1-based)
  of the full convolution — ``MTD/fun_lss_pulse_compression.m:57-65``;
* narrow pulse: 35-tap FIR, taps normalised by their max, output scaled by
  1/1.2 and advanced by the group delay ``round(17)`` (half away from zero)
  with a circular shift — ``MTD/fun_lss_pulse_compression.m:31-51``;
* G0 short pulse: the raw taps, neither normalised, scaled nor shifted —
  ``DMX_SignalProcessing_main_xzr.m:146,343-344``;
* G0 long pulse: fixed-length frequency-domain matched filter
  ``ifft(fft(x, 512) .* matchF2)`` — ``DMX_SignalProcessing_main_xzr.m:348-353``;
* G1 range re-concatenation after compression, 1031 -> 868 columns —
  ``fun_lss_range_concate.m:4-8``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from radar_signal_process_tpu_torch.config import (
    NARROW_PULSE_FIR_TAPS,
    RadarProfile,
    matlab_round,
)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_len(conv_len: int) -> int:
    """Smallest 5-smooth length >= ``conv_len``.

    Any length >= N+M-1 gives an exact linear convolution; 5-smooth sizes
    are fast for both cuFFT and pocketfft, and the JAX package picks the
    same length on its CPU backend.
    """
    best = _next_pow2(conv_len)
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            p = p35
            while p < conv_len:
                p *= 2
            best = min(best, p)
            p35 *= 3
        p5 *= 5
    return best


def matched_filter_spectrum(pulse: np.ndarray, n_echo: int) -> np.ndarray:
    """FFT of ``conj(flip(pulse))`` at the convolution length for ``n_echo``."""
    pulse = np.asarray(pulse, dtype=np.complex128)
    h = np.conj(pulse[::-1])
    return np.fft.fft(h, fft_len(len(pulse) + n_echo - 1))


def fir_spectrum(n_echo: int, normalize: bool = True) -> np.ndarray:
    """FFT of the narrow-pulse FIR taps for ``n_echo`` samples; the taps are
    normalised by their max unless ``normalize`` is False (the G0 raw form)."""
    b = np.asarray(NARROW_PULSE_FIR_TAPS, dtype=np.float64)
    if normalize:
        b = b / b.max()
    return np.fft.fft(b, fft_len(n_echo + len(b) - 1))


def matched_filter_compress(
    echo: torch.Tensor, spectrum: torch.Tensor, pulse_len: int
) -> torch.Tensor:
    """Matched-filter compression along the last axis.

    ``spectrum`` is :func:`matched_filter_spectrum` (complex64, on the
    echo's device).  Returns the aligned segment of the echo's length: the
    full convolution sampled from ``pulse_len - 1``.
    """
    m = echo.shape[-1]
    full = torch.fft.ifft(torch.fft.fft(echo, spectrum.shape[-1], dim=-1) * spectrum, dim=-1)
    return full[..., pulse_len - 1 : pulse_len - 1 + m]


def fir_compress(
    echo: torch.Tensor,
    spectrum: torch.Tensor,
    n_taps: int,
    post_scale: float = 1.0 / 1.2,
    roll_group_delay: bool = True,
) -> torch.Tensor:
    """Causal FIR filtering along the last axis, ``filter(b, 1, x)``.

    ``spectrum`` is :func:`fir_spectrum` (complex64, on the echo's device).
    The G1/G2 form then advances by the group delay,
    ``circshift(y, -round(mean(grpdelay(b))))``, and scales by 1/1.2; the G0
    form (``post_scale=1.0, roll_group_delay=False`` with raw taps) does
    neither.
    """
    m = echo.shape[-1]
    nfft = spectrum.shape[-1]
    causal = torch.fft.ifft(torch.fft.fft(echo, nfft, dim=-1) * spectrum, dim=-1)[..., :m]
    if roll_group_delay:
        causal = torch.roll(causal, -matlab_round((n_taps - 1) / 2), dims=-1)
    return causal * post_scale


def fixed_length_matched_filter(echo: torch.Tensor, match_spec: torch.Tensor) -> torch.Tensor:
    """G0 long-pulse matched filter ``ifft(fft(x, L) * match_spec)`` with
    ``L = len(match_spec)``: ``fft(x, L)`` zero-pads or truncates ``x``."""
    n = match_spec.shape[-1]
    return torch.fft.ifft(torch.fft.fft(echo, n, dim=-1) * match_spec, dim=-1)


def segment_filters(
    profile: RadarProfile, pulses: Sequence[np.ndarray]
) -> Tuple[Tuple[np.ndarray, ...], Tuple[int, ...]]:
    """Per-segment filter spectra (complex128) and filter lengths.

    The narrow (chirp sign 0) segment gets the FIR taps, each chirped
    segment the matched filter of its reference pulse.
    """
    spectra, lens = [], []
    for i, npts in enumerate(profile.segment_points):
        if profile.chirp_signs[i] == 0:
            spectra.append(fir_spectrum(npts))
            lens.append(len(NARROW_PULSE_FIR_TAPS))
        else:
            spectra.append(matched_filter_spectrum(pulses[i], npts))
            lens.append(len(pulses[i]))
    return tuple(spectra), tuple(lens)


def segmented_pulse_compression(
    echo: torch.Tensor,
    profile: RadarProfile,
    spectra: Sequence[torch.Tensor],
    filter_lens: Sequence[int],
) -> torch.Tensor:
    """Segmented multi-pulse compression (``fun_lss_pulse_compression.m``).

    Splits the fast-time axis into the profile's pulse segments, compresses
    each with its filter (``segment_filters``) and re-concatenates; samples
    past the last segment are zero.
    """
    parts = []
    for i, (start, npts) in enumerate(
        zip(profile.segment_starts, profile.segment_points)
    ):
        seg = echo[..., start : start + npts]
        if profile.chirp_signs[i] == 0:
            parts.append(fir_compress(seg, spectra[i], filter_lens[i]))
        else:
            parts.append(matched_filter_compress(seg, spectra[i], filter_lens[i]))
    used = sum(profile.segment_points)
    if used < echo.shape[-1]:
        parts.append(torch.zeros_like(echo[..., used:]))
    return torch.cat(parts, dim=-1)


def range_concatenate(
    pc: torch.Tensor, spec: Sequence[Tuple[int, int, int]]
) -> torch.Tensor:
    """Drop the overlapping post-compression samples and re-concatenate the
    segments (``fun_lss_range_concate.m:4-8``; G1: 1031 -> 868 columns).

    ``spec`` entries are ``(dst_start, dst_stop, src_start)``, half-open and
    0-based (``config.G1_RANGE_CONCAT``).  The result is a new contiguous
    tensor.
    """
    return torch.cat(
        [pc[..., src : src + (stop - start)] for start, stop, src in spec], dim=-1
    )

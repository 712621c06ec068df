"""The G2 window chain, plainly: DBF, pulse compression, slicing, Doppler.

After ``bin_to_mat_xzr.m`` / ``FrameDataRead_xzr.m:150-159`` (DBF, a
non-conjugating projection of the 16 channels onto the beams),
``MTD/fun_lss_pulse_compression.m`` (per segment: the narrow pulse through
the normalised 35-tap FIR, scaled by 1/1.2 and advanced circularly by its
group delay; the chirps through their matched filters, the full linear
convolution sampled from the pulse's length) and
``main_produce_dataset_win_xzr_v2.m:75-136`` with ``fun_Process_MTD.m`` and
``fun_0v_pressing.m`` (two frames make a doubled CPI, ``win_size``
overlapping slices, a Kaiser-windowed slow-time FFT, fftshift, magnitude,
the zero-velocity rows zeroed).

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control of ``correct``: the same chain with both products (DBF and the
Doppler transform, as a matmul against the windowed DFT plane) taking
operands rounded to TF32, the step below float32, with float32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.common import (
    matlab_round,
    reference_pulses,
    segment_starts,
    shifted_notch_rows,
    window,
)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) rounded to TF32's 10 mantissa bits, to nearest."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def compress(echo: torch.Tensor, profile: dict, taps) -> torch.Tensor:
    """Segmented pulse compression along the last axis of ``echo``."""
    cdt = echo.dtype
    parts = []
    pulses = reference_pulses(profile)
    for i, (start, n) in enumerate(zip(segment_starts(profile), profile["segment_points"])):
        seg = echo[..., start:start + n]
        if profile["chirp_signs"][i] == 0:
            b = np.asarray(taps, np.float64)
            b = b / b.max()
            h = b.astype(np.complex128)
            lag = matlab_round((len(b) - 1) / 2)
            scale = 1.0 / 1.2
        else:
            h = np.conj(pulses[i][::-1])
            lag, scale = None, 1.0
        size = _next_pow2(n + len(h) - 1)
        spec = torch.as_tensor(np.fft.fft(h, size), dtype=cdt, device=echo.device)
        full = torch.fft.ifft(torch.fft.fft(seg, size, dim=-1) * spec, dim=-1)
        if lag is None:
            parts.append(full[..., len(h) - 1:len(h) - 1 + n])
        else:
            parts.append(torch.roll(full[..., :n], -lag, dims=-1) * scale)
    used = sum(profile["segment_points"])
    if used < echo.shape[-1]:
        parts.append(torch.zeros_like(echo[..., used:]))
    return torch.cat(parts, -1)


def slice_starts(n_prt: int, win_size: int) -> list[int]:
    return [matlab_round(i * n_prt / win_size) for i in range(win_size)]


def window_rdms(prev: np.ndarray, cur: np.ndarray, coeffs: np.ndarray, config: dict,
                device, precision: str = "float64") -> torch.Tensor:
    """Two consecutive frames (n_prt, n_samples, n_channels) -> the window's
    (n_beams, win_size, n_prt, n_samples) magnitude RDMs, in float64 for the
    reference and float32 for the TF32 control."""
    profile, win = config["profile"], config["stream"]["win_size"]
    cdt = torch.complex128 if precision == "float64" else torch.complex64
    n_prt = profile["prt_per_frame"]
    c = torch.as_tensor(coeffs, dtype=cdt, device=device)
    if precision == "tf32":
        c = tf32(c)
    beams = []
    for frame in (prev, cur):
        x = torch.as_tensor(frame, device=device).to(cdt)
        if precision == "tf32":
            x = tf32(x)
        beams.append(torch.matmul(x, c.T).permute(2, 0, 1))     # (beams, prt, samples)
    echo = torch.cat(beams, 1)
    del beams
    pc = compress(echo, profile, config["narrow_pulse_fir_taps"])
    del echo
    mtd = profile["mtd"]
    w = window(mtd["window"], n_prt, mtd["window_beta"])
    lo, hi = shifted_notch_rows(n_prt, mtd["notch_divisor"])
    out = torch.empty((pc.shape[0], win, n_prt, pc.shape[-1]),
                      dtype=torch.float64 if precision == "float64" else torch.float32,
                      device=device)
    if precision == "tf32":
        k = np.arange(n_prt)
        plane = np.exp(-2j * np.pi * k[:, None] * k[None, :] / n_prt) * w[None, :]
        plane = tf32(torch.as_tensor(np.fft.fftshift(plane, axes=0), dtype=cdt, device=device))
    wt = torch.as_tensor(w, dtype=pc.real.dtype, device=device)
    for s, start in enumerate(slice_starts(n_prt, win)):
        x = pc[:, start:start + n_prt]
        if precision == "tf32":
            spec = torch.matmul(plane, tf32(x))
        else:
            spec = torch.fft.fftshift(torch.fft.fft(x * wt[:, None], dim=-2), dim=-2)
        mag = spec.abs()
        mag[:, lo:hi + 1] = 0.0
        out[:, s] = mag
    return out

"""The G0 frame chain, plainly, after ``CFAR_WangCai/DMX_SignalProcessing_main_xzr.m``.

Per frame and beam: the short pulse through the raw 35-tap FIR (:343-344),
the long pulse through the power-normalised, Kaiser(4.5)-windowed LFM
matched filter of 512 points (:161-202, :346-353), a Hamming-windowed,
unshifted 2048-point slow-time FFT and the magnitude (:413-418); the
monopulse sum |L|+|R| with its clutter rows zeroed and the difference
|R|-|L| (:420-465).  ``precision="tf32"`` is the control of ``correct``:
both products as matmuls (the pulse compression's operator, the windowed
DFT plane) with operands rounded to TF32 and float32 sums.

:func:`measurements` is the sub-bin estimate of ``motionParaMeasure.m``
(not-a-knot spline upsampling, first maximum, monopulse ratio): a frozen
copy of the port's float32 form, so that it reads the program's detections
and RDMs and gives the program's numbers exactly when they are right.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.common import C_LIGHT, window
from benchmark.reference.g2 import tf32

G0_C = 299792458.0


def frame_scalars(config: dict, freq_index: int, beam_pos: int) -> dict:
    """Wavelength, Doppler cell, clutter rows, velocity scale and monopulse
    slope of one frame (:310-327, :506-516)."""
    prof, chain = config["profile"], config["chain"]
    wavelength = G0_C / (config["freq_table_mhz"][freq_index] * 1e6)
    n_fft = chain["mtd_fft_length"]
    d_doppler = (1.0 / prof["prt"]) / n_fft
    delta_v = wavelength * d_doppler / 2.0
    f_scale = np.fft.fftshift(np.arange(-n_fft // 2, n_fft // 2) * d_doppler)
    return {"wavelength": wavelength, "delta_v": float(delta_v),
            "n_clutter": int(math.floor(chain["mtd_clutter_v"] / delta_v)),
            "v_scale": -wavelength * f_scale / 2.0,
            "k_value": float(config["k_value_table"][freq_index][beam_pos])}


def _match_spectrum(config: dict) -> np.ndarray:
    prof, chain = config["profile"], config["chain"]
    tau = prof["pulse_widths"][1]
    ts = 1.0 / prof["fs"]
    n = int(round(tau / ts))
    t = np.arange(n) * ts - tau / 2.0
    wf = np.exp(1j * np.pi * (prof["bandwidth"] / tau) * t * t)
    if config["dmx"]["power_norm"]:
        wf = wf / np.linalg.norm(wf)
    wf = wf * window(chain["pc_window"], n, chain["pc_window_beta"])
    return np.conj(np.fft.fft(wf, chain["pc_fft_length"]))


def _operators(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """The two pulse compressions as (n_in, n_out) matrices, complex128."""
    prof, chain = config["profile"], config["chain"]
    ps = prof["segment_points"][0]
    pl = prof["point_prt"] - ps
    n = chain["pc_fft_length"]
    taps = np.asarray(config["narrow_pulse_fir_taps"], np.float64)
    short = np.zeros((ps, ps), np.complex128)
    for m in range(ps):
        for d in range(min(len(taps), ps - m)):
            short[m, m + d] = taps[d]
    fwd = np.exp(-2j * np.pi * np.arange(pl)[:, None] * np.arange(n)[None, :] / n)
    fwd[n:] = 0.0
    inv = np.exp(2j * np.pi * np.arange(n)[:, None] * np.arange(n)[None, :] / n) / n
    return short, (fwd * _match_spectrum(config)[None, :]) @ inv


def beam_rdms(beams: torch.Tensor, config: dict, precision: str = "float64"):
    """(2, n_prt, point_prt) echo of both beams -> |RDM| of each beam,
    (2, n_fft, n_short) and (2, n_fft, pc_fft)."""
    prof, chain = config["profile"], config["chain"]
    ps = prof["segment_points"][0]
    n_prt, n_fft = prof["prt_per_frame"], chain["mtd_fft_length"]
    w = window(chain["mtd_window"], n_prt, chain["mtd_window_beta"])
    dev = beams.device
    if precision == "tf32":
        short, long_ = (tf32(torch.as_tensor(m, dtype=torch.complex64, device=dev))
                        for m in _operators(config))
        k = np.arange(n_fft)[:, None] * np.arange(n_prt)[None, :]
        plane = tf32(torch.as_tensor(np.exp(-2j * np.pi * k / n_fft) * w[None, :],
                                     dtype=torch.complex64, device=dev))
        x = tf32(beams.to(torch.complex64))
        outs = []
        for seg, op in ((x[..., :ps], short), (x[..., ps:], long_)):
            p = tf32(torch.matmul(seg, op))
            outs.append(torch.matmul(plane, p).abs())
        return tuple(outs)
    x = beams.to(torch.complex128)
    taps = torch.as_tensor(np.asarray(config["narrow_pulse_fir_taps"], np.float64),
                           dtype=torch.complex128, device=dev)
    size = 1 << (ps + len(taps) - 2).bit_length()
    short = torch.fft.ifft(torch.fft.fft(x[..., :ps], size) * torch.fft.fft(taps, size))[..., :ps]
    spec = torch.as_tensor(_match_spectrum(config), dtype=torch.complex128, device=dev)
    long_ = torch.fft.ifft(torch.fft.fft(x[..., ps:], chain["pc_fft_length"]) * spec)
    wt = torch.as_tensor(w, dtype=torch.float64, device=dev)[:, None]
    return tuple(torch.fft.fft(p * wt, n_fft, dim=-2).abs() for p in (short, long_))


def sum_diff(abs_short, abs_long, n_clutter: int):
    """Monopulse sum (clutter rows zeroed) and difference RDMs of each pulse."""
    out = []
    for a in (abs_short, abs_long):
        s = a[0] + a[1]
        n = s.shape[-2]
        keep = torch.ones(n, dtype=s.dtype, device=s.device)
        keep[: n_clutter + 1] = 0.0
        keep[n - n_clutter:] = 0.0
        out.append((s * keep[:, None], a[1] - a[0]))
    return out


# ----------------------------------------------------------- measurement
def _spline_eval_matrix(k: int, upsample: int) -> np.ndarray:
    a = np.zeros((k, k))
    rhs = np.zeros((k, k))
    a[0, 0:3] = (1.0, -2.0, 1.0)
    a[-1, -3:] = (1.0, -2.0, 1.0)
    for i in range(1, k - 1):
        a[i, i - 1:i + 2] = (1.0, 4.0, 1.0)
        rhs[i, i - 1:i + 2] = (6.0, -12.0, 6.0)
    c = np.linalg.solve(a, rhs)
    q = (k - 1) * upsample + 1
    p = np.zeros((q, k))
    for qi in range(q):
        t = qi / upsample
        j = min(int(np.floor(t)), k - 2)
        s = t - j
        w_y, w_m = np.zeros(k), np.zeros(k)
        w_y[j] += 1.0 - s
        w_y[j + 1] += s
        w_m[j] += (1.0 - s) ** 3 / 6.0 - (1.0 - s) / 6.0
        w_m[j + 1] += s ** 3 / 6.0 - s / 6.0
        p[qi] = w_y + w_m @ c
    return p


def measurements(rdm_sum, rdm_diff, v_idx, r_idx, r_scale: np.ndarray, scal: dict,
                 beam_pos: int, config: dict):
    """float32 (range m, velocity m/s, elevation deg) of each detection."""
    chain, prof = config["chain"], config["profile"]
    e = chain["extra_dots"]
    nv, nr = rdm_sum.shape
    w = 2 * e + 1
    dt, dev = rdm_sum.dtype, rdm_sum.device
    p_r = torch.as_tensor(_spline_eval_matrix(w, chain["r_interp_times"]), dtype=dt, device=dev)
    p_v = torch.as_tensor(_spline_eval_matrix(w, chain["v_interp_times"]), dtype=dt, device=dev)
    r_scale = torch.as_tensor(r_scale, dtype=dt, device=dev)
    v_scale = torch.as_tensor(scal["v_scale"], dtype=dt, device=dev)
    v, r = v_idx.long(), r_idx.long()
    offs = torch.arange(w, device=dev)
    r_start = (r - e).clamp(0, nr - w)
    i1 = torch.argmax(rdm_sum[v[:, None], r_start[:, None] + offs] @ p_r.T, dim=-1)
    r_cell = r_start.to(dt) + i1.to(dt) / chain["r_interp_times"]
    delta_r = C_LIGHT / (2.0 * prof["fs"])
    r_est = r_scale[r] + (r_cell - r.to(dt)) * delta_r
    n_c = scal["n_clutter"]
    v_start = (v - e).clamp(n_c + 1, nv - n_c - 1 - (w - 1)).clamp(0, nv - w)
    i2 = torch.argmax(rdm_sum[v_start[:, None] + offs, r[:, None]] @ p_v.T, dim=-1)
    v_cell = v_start.to(dt) + i2.to(dt) / chain["v_interp_times"]
    v_int = torch.floor(v_cell).long()
    v_est = v_scale[v_int] - (v_cell - v_int.to(dt)) * scal["delta_v"]
    ratio = rdm_diff[v, r] / rdm_sum[v, r]
    ele = (beam_pos * chain["beam_angle_step"] + 2.5 - ratio * scal["k_value"]
           + chain["ele_angle_comp"] + chain["ele_angle_sys_err"])
    return r_est, v_est, ele


def range_scales(config: dict) -> tuple[np.ndarray, np.ndarray]:
    prof, chain = config["profile"], config["chain"]
    d_r = C_LIGHT / (2.0 * prof["fs"])
    short = (np.arange(prof["segment_points"][0]) * d_r + chain["r_sys_err_short"]
             - chain["r_measure_err_short"])
    long_ = (np.arange(chain["pc_fft_length"]) * d_r + chain["r_sys_err_long"]
             - chain["r_measure_err_long"])
    return short, long_

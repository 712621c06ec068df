"""The G1 window chain, plainly: pulse compression, range re-concatenation,
slicing, Doppler.

After ``MatlabProcess_xuzerui/main.m:206-239``: the three pulses
compressed per segment (``fun_lss_pulse_compression.m``, the narrow pulse
through the normalised 35-tap FIR, the up- and down-chirps of ``main.m:55-56``
through their matched filters: ``g2.compress``), the overlapping samples
dropped and the segments re-concatenated by the configuration's
``range_concat`` table (``fun_lss_range_concate.m:4-8``, 1031 -> 868
columns), a Kaiser(8)-windowed slow-time FFT, fftshift, magnitude and the
/150 zero-velocity notch (``fun_0v_pressing.m``); then the CFAR stage
(``CFAR_WangCai/main_cfar.m:21-35,85-96,143-145``: T = 5, the /20 re-notch,
the cascade over the three segments of the 868 columns, the detection
list), by ``reference/cfar.py``.

Departures from the MATLAB, each the stream's and not the reference's own:

* the CPI is the stream's window: two consecutive frames make a doubled
  CPI of 3072 PRTs and ``win_size`` overlapping slices of 1536 are
  transformed (``main_produce_dataset_win_xzr_v2.m:75-136``, as for G2),
  where ``main.m`` transforms each frame once;
* the reference pulses are synthesized, as ``main.m:68-80`` does; no
  measured waveform;
* the beams arrive as complex samples, the 24-bit words already parsed
  (``frameDataRead_A_xzr.m``); there is no DBF, the two channels are the
  two beams.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control of ``correct``: the same chain with the Doppler transform as a
matmul against the windowed DFT plane, its operands rounded to TF32, the
step below float32, with float32 sums.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import cfar as ref_cfar
from benchmark.reference.common import C_LIGHT, clutter_cells, shifted_notch_rows, window
from benchmark.reference.g2 import compress, slice_starts, tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def range_concatenate(pc: torch.Tensor, table) -> torch.Tensor:
    """The columns ``[src, src + stop - start)`` of each ``(start, stop,
    src)`` entry, side by side."""
    return torch.cat([pc[..., src:src + stop - start] for start, stop, src in table], -1)


def window_rdms(prev: np.ndarray, cur: np.ndarray, config: dict, device,
                precision: str = "float64") -> torch.Tensor:
    """Two consecutive frames (n_beams, n_prt, n_samples) -> the window's
    (n_beams, win_size, n_prt, n_columns) magnitude RDMs, ``n_columns`` the
    re-concatenated width; float64 for the reference, float32 for the TF32
    control."""
    profile, win = config["profile"], config["stream"]["win_size"]
    cdt = torch.complex128 if precision == "float64" else torch.complex64
    n_prt = profile["prt_per_frame"]
    echo = torch.cat([torch.as_tensor(f, device=device).to(cdt) for f in (prev, cur)], 1)
    pc = range_concatenate(compress(echo, profile, config["narrow_pulse_fir_taps"]),
                           config["range_concat"])
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


def n_clutter(config: dict) -> int:
    """The clutter rows each side of zero velocity at ``clutter_v``
    (``main_cfar.m:56-58``), from the configuration's wavelength and PRF."""
    prof = config["profile"]
    return clutter_cells(config["stream"]["clutter_v"], C_LIGHT / prof["fc"], 1.0 / prof["prt"],
                         prof["prt_per_frame"])


def renotch_rows(config: dict):
    """The rows the CFAR stage's /20 re-notch zeroes inside the crop."""
    prof = config["profile"]
    return ref_cfar.renotch_zero_rows(prof["prt_per_frame"], config["stream"]["renotch_divisor"],
                                      n_clutter(config), prof["mtd"]["fftshift"])


def cascade(rdms: torch.Tensor, config: dict):
    """float32 RDMs -> bool ``(flags, vflags)``: the re-notch and the cascade
    over the configuration's segments."""
    prof = config["profile"]
    return ref_cfar.cascade(rdms, prof["cfar"], n_clutter(config),
                            [tuple(s) for s in prof["cfar_segments"]], renotch_rows(config))


def detection_list(flags: torch.Tensor, rdms: torch.Tensor, config: dict):
    """The stable-sort list of each RDM's ``max_detections`` strongest
    flagged cells (``reference/cfar.py``)."""
    return ref_cfar.detection_list(flags, rdms, config["stream"]["max_detections"])

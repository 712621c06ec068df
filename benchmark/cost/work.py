"""The work that each kernel's function needs, whatever implements it.

Frozen here, apart from the program, so that a change to a kernel cannot
change the yardstick it is read against.  The rules:

* each distinct input element that the call's outputs depend on is read
  once (B2: the compressed window's rows that its slices cover, not a
  stacked copy; the windows and filters as vectors, not as DFT planes or
  operator matrices);
* each output is written once;
* a DFT counts as an FFT, ``5 N log2 N`` real operations for N complex
  points; a complex product 6, a complex times real 2, a magnitude 4 (two
  products, a sum, a root); all at the FP32 peak (no FP32-accurate
  product needs the tensor cores);
* rows that the CFAR stage's re-notch defines as zero are not read.

Each function returns ``(bytes, operations)``; :func:`bound_s` turns them
into the least time on the card (``peaks.json``).
"""

from __future__ import annotations

import json
import math
import pathlib

PEAKS = json.loads(pathlib.Path(__file__).with_name("peaks.json").read_text())


def fft_ops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def bound_s(n_bytes: float, ops: float, peaks: dict = PEAKS) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    the FP32 peak, in seconds."""
    return max(n_bytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_ops_per_s"])


def rdm_former(n_beams: int, n_prt: int, n_range: int, slice_starts) -> tuple[float, float]:
    """B2 over one window: ``|FFT(w * x)|`` of every (beam, slice, range
    column), fftshift and notch being placement.  Reads the complex64 rows
    ``[min(start), max(start) + n_prt)`` of each beam once and the window
    once; writes the float32 RDMs once."""
    win = len(slice_starts)
    rows = max(slice_starts) + n_prt - min(slice_starts)
    n_bytes = n_beams * rows * n_range * 8 + n_prt * 4 + n_beams * win * n_prt * n_range * 4
    ops = n_beams * win * n_range * (2.0 * n_prt + fft_ops(n_prt) + 4.0 * n_prt)
    return float(n_bytes), ops


def cascaded_cfar(batch: int, n_velocity: int, n_range: int, n_clutter: int,
                  notched_rows: int = 0) -> tuple[float, float]:
    """B1 on ``batch`` float32 RDMs: the used rows read once, less the
    ``notched_rows`` among them that the re-notch defines as zero; the
    cascade flags and the velocity flags written once, a byte a cell.  Per
    used cell and axis: two running sums (an add and a subtract each), two
    means, the greater (or smaller), the product with the threshold and the
    compare."""
    nvu = n_velocity - 2 * n_clutter - 1
    if not 0 <= notched_rows <= nvu:
        raise ValueError(f"{notched_rows} notched rows of {nvu} used rows")
    n_bytes = batch * (nvu - notched_rows) * n_range * 4 + 2 * batch * n_velocity * n_range
    return float(n_bytes), 2.0 * 9.0 * batch * nvu * n_range


def fused_pc_rdm(n_beams: int, n_prt: int, n_in: int, n_out: int, n_fft: int,
                 fir_taps: int = 0, pc_fft: int = 0) -> tuple[float, float]:
    """B3 on one pulse segment of ``n_beams`` beams: ``|FFT_nfft(w * PC(x))|``.
    ``fir_taps`` > 0: PC is a causal FIR with real taps (``n_out`` outputs
    of up to ``fir_taps`` taps, 4 operations a tap); else a fast convolution
    of ``pc_fft`` points (forward FFT, a complex product, inverse FFT).
    Reads the complex64 echo, the window and the filter once; writes the
    float32 RDM once."""
    if fir_taps:
        pc_ops = 4.0 * sum(min(n + 1, fir_taps) for n in range(n_out))
        filt = fir_taps * 4
    else:
        pc_ops = 2.0 * fft_ops(pc_fft) + 6.0 * pc_fft
        filt = pc_fft * 8
    n_bytes = n_beams * n_prt * n_in * 8 + n_prt * 4 + filt + n_beams * n_fft * n_out * 4
    ops = n_beams * (n_prt * pc_ops + n_out * (2.0 * n_prt + fft_ops(n_fft) + 4.0 * n_fft))
    return float(n_bytes), ops

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radar_signal_process_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one line (or a few), any failure exits non-zero:

1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions; exits
   non-zero at once when ``torch.cuda.is_available()`` is false;
2. build   — compiles ``kernels/csrc/*.cu`` with nvcc for sm_90a, one nvcc
   per source, all started together; prints ptxas registers and spills;
3. B2      — the RDM-former kernel against its plain matmul version (and the
   cuFFT form) at G2 geometry, 52 x 332 x 3404, f32 tolerance; both the
   kernel's and the plain version's max error against the product taken in
   complex128 on the card, as a share of the peak (the kernel's at most
   1e-5); its bound (3xTF32 operations at the TF32 peak), its
   FP32-equivalent TFLOP/s and share of the bound, and the time of the one
   PyTorch call of the complex product (``torch.matmul``, its
   ``library_ms``, which the port never calls);
4. B1      — the cascaded-CFAR kernel against its plain version, bit for bit,
   on the B2 output (three G2 segments) with the divisor-20 re-notch fused
   into its load (``zero_rows`` (148, 183), the main path's form) and as a
   product before it, and on crafted RDMs (notched rows, ties, edge columns,
   a cell exactly on the threshold, no range pass, E=2, smallest-of, the
   notch rows negative in memory and fused); its division by 5 against
   IEEE division on all 2^32 float32 bit patterns; ``detect_rdm`` on the
   window under ``torch.cuda.set_sync_debug_mode("error")`` (no host copy,
   no stream synchronisation); then, fused and as a product, timed in turns
   with the plain version, its time per call, its device time (a CUDA graph
   of 20 calls) and its enqueue time, bytes moved, GB/s, the share of the
   3.35 TB/s byte floor (the fused form's without the notched rows) and the
   launches of one call (one for all segments), beside the card's name and
   power limit;
5. slice   — writes a seeded 4-frame 16-channel G2 capture with one point
   target and runs ``radar_signal_process_tpu_torch.cli stream`` over it at
   full width (13 beams, win_size 4, 3 windows) with the CLI's default
   ``.bin`` reader; checks both kernels ran (B1 once per window),
   the RDMs are finite and agree with the plain versions, and the target is
   detected in the beam it steers to; times each stage with CUDA events;
6. B3      — the fused PC + RDM kernel against its plain version (two
   complex64 matmuls) and its cuFFT form at G0 geometry, both pulse
   segments of two beams (2 x 1536 x 62 -> 2 x 2048 x 62 and
   2 x 1536 x 504 -> 2 x 2048 x 512), each read in place from the beams;
   and both against the complex128 product, as for B2; each segment's
   device time (a CUDA graph of 20 calls) beside the plain version's, the
   cuFFT form's call time, the bound and the share of it, and the device
   time of the operator's image (made once an operator);
7. B1 (G0) — the CFAR kernel bit for bit against its plain version at G0
   geometry (2048 x 62, the narrow body, and 2048 x 512, the tile body; one
   segment, n_clutter 6), on B3's summed, notched output and on crafted
   RDMs; timed per segment as in 4 (device time beside the byte floor);
8. G0      — writes a seeded 4-frame G1 capture (the known-good target,
   per-frame frequency indices 5, 2, 9, 5) and runs
   ``radar_signal_process_tpu_torch.cli dmx`` over it at full G0 width;
   checks B3 and B1 ran (once a segment on each n_clutter's eager frame and
   on its graph's capture, none on a replay), the RDMs are finite and agree with the plain
   versions, and the target is measured within 0.3 m/s and 2 range cells in
   every frame; times each stage with CUDA events, the ``.bin`` parse, and
   the frame rate against the radar's 12.5 frames/s;
9. G1      — a seeded full-width G1 echo (2 beams x 1536 x 1031, the target
   of ``tests/test_chains.py``: -5.7 m/s at 320 m, 15 dB SCR) through
   ``g1_validation_chain`` on the card: B2 at 1536 x 1536 x 868 against its
   plain version and the complex128 product (1e-5 of the peak), the argmax
   within 0.3 m/s and the mid-segment peak at column 128, ms per call;
10. sweep  — ``radar_signal_process_tpu_torch.cli sweep --device cuda`` with
   its defaults at full G2 (3 SCRs x 3 thresholds x 4 frames): B2 once per
   SCR, B1 once per threshold per SCR; every threshold's B1 flags bit for
   bit against the plain version on the same RDMs; the table against the
   reference table (Pd, accuracy, PCF equal, FA rate within 1e-4);
11. e2e    — ``cli simulate`` writes 3 full-G2 frames (16 channels, target
   -5.7 m/s at 320 m), then ``cli e2e --frames 2 --device cuda``: B2 and B1
   once per window, the target detected in every window at its
   mid-segment column 281 or long-segment column 1004 (+-1), ms per window
   from the CLI's stage timers;
12. stages — the same capture through the stage CLIs and their file bus:
   ``cli ingest`` (npz) -> ``cli mtd`` (B2 once per frame pair) -> ``cli
   detect`` (B1 once per frame) over both frame pairs, the detections of
   every (channel, slice) equal to ``cli e2e``'s bit for bit; one frame pair
   through the ``.mat`` bus, equal to the npz bus bit for bit; ``ingest
   --dbf-coeffs`` (13 seeded beams) within 1e-5 of the peak of a complex128
   product; ``detect --thresholds 3 5 7`` (B1 once per threshold per
   frame), its T=5 files equal to ``--threshold 5``'s; the RDMs and flags
   written against B2's and B1's plain versions on the card; each stage's
   wall seconds per frame, file I/O apart from device time;
13. dmx outputs — ``cli dmx --gps --save-results`` (and ``--plots`` where
   matplotlib is installed, decided before the run) over the G0 phase's
   capture with a GPS track of the truth beside it: B3 and B1 as in 8,
   finite residuals for every long-pulse detection, the result
   struct with the chain's config echo;
14. mesh   — the multi-device layer on one card, run within phases 5 and 11
   on their captures: ``cli stream --mesh 1x1`` over the slice capture in
   an NCCL group of one
   (``parallel.initialize_distributed``, ``make_mesh``): B2 and B1 once
   per window, RDMs within the slice's tolerance of the unsharded stream's,
   flags equal to B1's plain version (``segmented_cfar``) on them, the
   target in every slice; one window's device time, sharded and unsharded;
   B1 on the halo-extended blocks of sp = 2 and 4 shards of a full-G2
   window as the sharded CFAR runs it (the re-notch fused), stitched, bit
   for bit against the plain version and B1 on the whole RDM, both timed,
   the blocks' device time beside their byte floor; and
   ``cli e2e --mesh 1x1`` over the e2e capture, its rows those of ``cli
   e2e`` for the slice and the profile's 13 beams, bit for bit.  NCCL takes one GPU per rank, so no
   group of more than one rank runs on one card;
15. block  — the block path (``models/host_parallel.py``), run within phase
   5 on its capture: ``StreamingPipeline(use_host_parallel=True,
   block_windows=2)`` (B2 and B1 once per block, PC once per frame), its
   RDMs within the slice's tolerance of the windowed stream's and whether
   they are bit-identical, its flags equal to B1's plain version on them,
   the target in every window, ``emit="detections"`` equal; 13 seeded G2
   beam frames on the card through ``make_stream_pipeline`` (K = 6, 12
   windows) against ``FrameProcessor`` + ``Detector``, and the first
   block's B2 launch (312 RDMs) against B2's plain version on its inputs:
   device ms per window,
   launches per window and peak memory of both; ``make_stream_processor``
   (PC once per frame), ``make_flags`` (one B1 launch) and the native C++
   cascade on the card's host, bit for bit against B1, with its ms per RDM;
16. bench  — ``radar_signal_process_tpu_torch.bench`` at a short length
   (3 headline calls a batch, a 7-frame e2e stream, the oracle skipped):
   every workload (the G2 headline window, the block form, the stages, G0,
   ingest, the e2e stream windowed and in blocks, the device's busy share)
   with its checks, B1 and B2 held to their plain versions on the first
   window, B1's flags on the headline window numbering 1,945,427 (the
   re-notch band's self-flagged rows, ROADMAP C8); its JSON line is printed
   as it stands and its launches per workload join the ``kernels`` line;
17. entry  — ``radar_signal_process_tpu_torch.entry``: ``entry()``'s forward
   step on its example window at full G2 width (13 x 664 x 3404 complex64
   from ``default_rng(0)``), B2 and B1 once each; its RDMs against B2's
   plain version on the same compressed slices (B2 run again on them gives
   the step's RDMs bit for bit, so the inputs are the step's), its flags
   bit for bit against B1's plain version on those RDMs; ms per call
   (median of 10, CUDA events) beside the bench headline's window time;
   then ``dryrun_multichip(1, "cuda")`` in an NCCL group of one (its pp,
   g0 and ep legs need two ranks or more, as in the JAX code): its line,
   each leg's device ms, finite outputs, and its launches join the
   ``kernels`` line.

The line before the last is a JSON summary of the kernels (with each one's
bound from ``kernels/cost_model.py``: the larger of its bytes over 3.35 TB/s
and its operations over the peak rate of their type); the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX and nothing of
the JAX package: only ``radar_signal_process_tpu_torch`` (whose ``ingest``
and ``sim`` modules give the capture reader and writer).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from radar_signal_process_tpu_torch.kernels import cost_model

SEED = 20250817
G2_BATCH, G2_PULSES, G2_RANGE = 52, 332, 3404
RDM_RTOL, RDM_ATOL = 2e-4, 2e-3   # the repo's f32 RDM tolerance
C128_PEAK = 1e-5                  # max |kernel - complex128 product| / peak
TARGET_V, TARGET_R = -5.7, 320.0  # m/s, m: the known-good G2 drive
G0_BATCH = 2                      # the two monopulse beams
G0_FREQ_INDEX = (5, 2, 9, 5)      # per-frame frequency index of the G0 capture
G0_BEAM_POS = (2, 2, 3, 2)
G0_REAL_TIME = 1.0 / (1536 * 52.08e-6)  # frames/s: one G0 frame per 80.0 ms
G1_SCR_DB = 15.0                  # the G1 golden drive (tests/test_chains.py)
# the full-G2 sweep of `cli sweep` with its defaults, computed by the JAX
# package (a copy of it run on a CPU): {(SCR dB, T): (Pd, FA rate, acc, PCF)}
SWEEP_REFERENCE = {
    (0.0, 3.0): (1.0, 3.35e-2, 1.0, 1.0), (0.0, 5.0): (1.0, 3.32e-2, 1.0, 1.0),
    (0.0, 7.0): (1.0, 3.31e-2, 1.0, 1.0), (10.0, 3.0): (1.0, 3.36e-2, 1.0, 1.0),
    (10.0, 5.0): (1.0, 3.32e-2, 1.0, 1.0), (10.0, 7.0): (1.0, 3.31e-2, 1.0, 1.0),
    (20.0, 3.0): (1.0, 3.36e-2, 1.0, 1.0), (20.0, 5.0): (1.0, 3.32e-2, 1.0, 1.0),
    (20.0, 7.0): (1.0, 3.31e-2, 1.0, 1.0),
}
SWEEP_FA_TOL = 1e-4               # the reference's FA rates carry 3 digits
REPS = 10
HEADLINE_FLAGS = 1945427          # B1's flags on the bench's headline window (ROADMAP C8)
SMI = {"line": ""}                # nvidia-smi name and power limit of the card


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fns: dict, reps: int = REPS) -> dict:
    """Median device ms of each callable, timed in turns with CUDA events."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in times.items()}


def graph_ms(fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: a CUDA graph of ``n`` calls, replayed
    and timed with CUDA events, so no host time of the wrapper is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return float(np.median(times))


def c128_error(got: torch.Tensor, exact: torch.Tensor) -> float:
    """max |got - exact| as a share of the peak of ``exact`` (float64)."""
    return float((got.double() - exact).abs().max() / exact.abs().max())


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("device: torch.cuda.is_available() is False — no GPU, nothing run",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    SMI["line"] = smi
    print(smi)
    print(f"device: {name} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}")
    return name


def phase_build() -> None:
    from radar_signal_process_tpu_torch.kernels import _build

    stale = _build.library_path()
    if stale.exists():  # always build from this checkout's sources
        stale.unlink()
    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"build: kernels/_build/{_build.library_path().name} from "
          f"{len(list(_build.CSRC.glob('*.cu')))} sources (nvcc sm_90a) in {dt:.2f} s")
    log = _build.library_path().with_suffix(".log").read_text()
    src = "?"
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif "registers" in line or "spill" in line:
            print(f"  ptxas [{src}]: {line.strip()}")


def phase_rdm(dev) -> tuple[dict, torch.Tensor]:
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels.rdm import doppler_rdm, doppler_rdm_plain
    from radar_signal_process_tpu_torch.ops.mtd import (
        doppler_process,
        notch_rows,
        zero_velocity_notch,
    )
    from radar_signal_process_tpu_torch.params import chain_params

    rng = np.random.default_rng(SEED)
    shape = (G2_BATCH, G2_PULSES, G2_RANGE)
    pc_np = np.empty(shape, np.complex64)
    pc_np.real = rng.standard_normal(shape, dtype=np.float32)
    pc_np.imag = rng.standard_normal(shape, dtype=np.float32)
    pc = torch.from_numpy(pc_np).to(dev)
    del pc_np
    params = chain_params(prof, device=dev)
    window = params.window.double().cpu().numpy()
    notch = notch_rows(G2_PULSES, prof.mtd.notch_divisor)

    def run_kernel():
        return doppler_rdm(pc, params.dft_re, params.dft_im, notch)

    def run_plain():
        return doppler_rdm_plain(pc, params.dft_re, params.dft_im, notch)

    def run_fft():
        return zero_velocity_notch(doppler_process(pc, window), divisor=prof.mtd.notch_divisor)

    w_c = torch.complex(params.dft_re, params.dft_im)

    def run_library():  # the one PyTorch call of the complex product (no abs, no notch)
        return torch.matmul(w_c, pc)

    got, want, fft = run_kernel(), run_plain(), run_fft()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"B2: bad output shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool((err <= RDM_ATOL + RDM_RTOL * want.abs()).all())
    ok_fft = bool(((got - fft).abs() <= RDM_ATOL + RDM_RTOL * fft.abs()).all())
    if not (notch[0] == 163 and notch[1] == 167 and (got[:, 163:168] == 0).all()):
        fail(f"B2: notch rows {notch} not zeroed")
    exact = torch.matmul(torch.complex(params.dft_re, params.dft_im).to(torch.complex128),
                         pc.to(torch.complex128)).abs()
    exact[:, notch[0] : notch[1] + 1] = 0.0
    err_c128, plain_c128 = c128_error(got, exact), c128_error(want, exact)
    del exact
    print(f"B2 vs complex128 product: max error / peak kernel {err_c128:.3e} "
          f"plain {plain_c128:.3e} (kernel <= {C128_PEAK}) -> "
          f"{'ok' if err_c128 <= C128_PEAK else 'FAIL'}")
    if err_c128 > C128_PEAK:
        fail("B2: kernel error against the complex128 product above 1e-5 of the peak")
    ms = cuda_ms({"kernel": run_kernel, "plain": run_plain, "cufft": run_fft,
                  "library": run_library})
    print(f"B2 doppler_rdm {shape}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max_rel:.3e} vs plain (rtol {RDM_RTOL}, atol {RDM_ATOL}) -> "
          f"{'ok' if ok else 'FAIL'}; vs cuFFT -> {'ok' if ok_fft else 'FAIL'}; "
          f"median ms kernel {ms['kernel']:.3f} plain-matmul {ms['plain']:.3f} "
          f"cufft {ms['cufft']:.3f} library (complex matmul) {ms['library']:.3f}")
    if not (ok and ok_fft):
        fail("B2: kernel disagrees with its plain version")
    c = cost_model.rdm_former_cost(G2_BATCH, G2_PULSES, G2_RANGE)
    bound, bound_by, flops = c["sol_s"] * 1e3, c["bound_by"], c["flops"] / cost_model.TF32_SPLIT
    print(f"B2 bound (kernels/cost_model.py): {bound:.3f} ms by {bound_by} (3xTF32: "
          f"{c['flops']:.3e} TF32 flops at 495 TFLOP/s; {c['hbm_bytes'] / 1e6:.1f} MB at "
          f"3.35 TB/s; the FP32 route's bound "
          f"{flops / cost_model.H100_FP32_FLOPS * 1e3:.3f} ms at 67 TFLOP/s) | {SMI['line']}")
    tflops = flops / ms["kernel"] / 1e9
    print(f"B2 rate: {tflops:.1f} FP32-equivalent TFLOP/s ({flops:.3e} flops of the complex "
          f"product in {ms['kernel']:.3f} ms), {100 * bound / ms['kernel']:.1f}% of the bound "
          f"| {SMI['line']}")
    del want, fft, pc, w_c
    return {"max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"],
            "fp32_eq_tflops": tflops,
            "cufft_ms": ms["cufft"], "error_vs_c128": err_c128,
            "plain_error_vs_c128": plain_c128}, got


def _on_threshold_value() -> tuple[np.float32, np.float32]:
    """A reference-cell value v whose 5-term window mean ``sum / 5`` is one
    ulp below ``sum * (1/5)``, and the cell value exactly on the threshold
    ``fl(fl(sum/5) * 5)``: a kernel that multiplied by the reciprocal would
    miss the flag."""
    rng = np.random.default_rng(SEED)
    five, inv = np.float32(5.0), np.float32(1.0) / np.float32(5.0)
    for v in rng.uniform(0.5, 2.0, 10000).astype(np.float32):
        s = v
        for _ in range(4):
            s = np.float32(s + v)
        if np.float32(s / five) < np.float32(s * inv):
            return v, np.float32(np.float32(s / five) * five)
    fail("no on-threshold value found")


def crafted_rdm(shape, rng, n_clutter: int, segments, unshifted: bool = False) -> np.ndarray:
    """RDM with notched zero rows, exact neighbour ties, segment-edge hits and
    a cell exactly on its CFAR threshold.  The notched rows are the G2
    divisor-20 re-notch band, or with ``unshifted`` the G0 clutter rows at
    both ends of the unshifted spectrum."""
    b, nv, nr = shape
    rdm = (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    if unshifted:
        rdm[:, : n_clutter + 1, :] = 0.0
        rdm[:, nv - n_clutter :, :] = 0.0
    else:
        c = nv // 2 - 1
        rdm[:, c - 17 : c + 18, :] = 0.0           # divisor-20 re-notch band
    lo, hi = n_clutter + 1, nv - n_clutter
    for k in range(b):
        for _ in range(200):
            v, r = int(rng.integers(lo, hi)), int(rng.integers(0, nr))
            rdm[k, v, r] += 40.0
            if r + 1 < nr and rng.random() < 0.5:  # exact tie with a neighbour
                rdm[k, v, r + 1] = rdm[k, v, r]
        for a, e in segments:                      # segment-edge columns
            for r in (a, a + 1, e - 2, e - 1):
                rdm[k, int(rng.integers(lo, hi)), r] += 40.0
    v, x = _on_threshold_value()                   # one cell on its threshold
    c0 = min(300, nr - 40)
    rdm[0, lo + 40 : lo + 80, c0 : c0 + 40] = v
    rdm[0, lo + 60, c0 + 20] = x
    return rdm


def enqueue_ms(fn, n: int = 20) -> float:
    """Host ms a call of ``fn`` takes to enqueue (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def b1_report(label: str, x: torch.Tensor, cfg, n_clutter: int, kernel, plain,
              notched_rows: int = 0) -> dict:
    """Time B1 and its plain version in turns, count the launches of one
    call, and hold the time against the byte floor: the used rows of the
    f32 RDM read once (less ``notched_rows`` that the fused re-notch does
    not read), both byte-wide flag maps written once."""
    from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d

    nv, nr = x.shape[-2], x.shape[-1]
    c = cost_model.cascaded_cfar_cost(x.numel() // (nv * nr), nv, nr, n_clutter, cfg,
                                      notched_rows=notched_rows)
    n_bytes, bound, bound_by = c["hbm_bytes"], c["sol_s"] * 1e3, c["bound_by"]
    before = cascaded_cfar2d.launches
    kernel()
    per_call = cascaded_cfar2d.launches - before
    ms = cuda_ms({"kernel": kernel, "plain": plain})
    dev_ms = graph_ms(kernel)
    host_ms = enqueue_ms(kernel)
    print(f"B1 timing [{label}] {tuple(x.shape)}: kernel {ms['kernel']:.4f} ms per call "
          f"(CUDA events around the call), {dev_ms:.4f} ms device time (CUDA graph of 20 "
          f"calls), {host_ms:.4f} ms to enqueue (host clock); plain {ms['plain']:.4f} ms; "
          f"{n_bytes / 1e6:.2f} MB moved -> {n_bytes / dev_ms / 1e6:.1f} GB/s device, "
          f"{n_bytes / ms['kernel'] / 1e6:.1f} GB/s per call; byte floor {bound:.4f} ms at "
          f"3.35 TB/s ({bound_by}) = {100 * bound / dev_ms:.1f}% device, "
          f"{100 * bound / ms['kernel']:.1f}% per call; {per_call} launch(es) per call | "
          f"{SMI['line']}")
    if per_call != 1:
        fail(f"B1 [{label}]: {per_call} launches in one call (want 1)")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "device_ms": dev_ms,
            "enqueue_ms": host_ms, "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes,
            "launches_per_call": per_call}


def phase_cfar(dev, rdm_b2: torch.Tensor) -> dict:
    """B1 on the B2 output with the CFAR stage's re-notch fused into its load
    (``zero_rows``, the main path's form) and as a product before it, and on
    crafted RDMs, each bit for bit against the plain version; the exhaustive
    check of its division by 5; ``detect_rdm`` enqueued with no stream
    synchronisation; its times."""
    import dataclasses

    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.models.detect import (
        clutter_cells,
        detect_rdm,
        renotch_mask,
        renotch_rows,
    )

    segments = prof.cfar_segments
    n_clutter = clutter_cells(prof, G2_PULSES)
    zero = renotch_rows(prof, G2_PULSES, n_clutter, 20)
    if zero != (148, 183):
        fail(f"B1: the G2 re-notch rows are {zero}, not (148, 183)")
    mask = torch.from_numpy(renotch_mask(prof, G2_PULSES, n_clutter, 20)).to(dev)
    rdm_n = (rdm_b2 * mask[:, None]).contiguous()
    cfg = prof.cfar
    cases = [("B2 output, renotch /20 fused", rdm_b2, cfg, zero),
             ("B2 output, renotch /20 as a product", rdm_n, cfg, None)]
    crafted = torch.from_numpy(
        crafted_rdm((4, G2_PULSES, G2_RANGE), np.random.default_rng(SEED + 1),
                    n_clutter, segments)
    ).to(dev)
    negative = crafted.clone()
    negative[:, zero[0] : zero[1]] = -crafted[:, 20 : 20 + zero[1] - zero[0]]
    cases += [
        ("crafted", crafted, cfg, None),
        ("crafted range_detect=False", crafted, dataclasses.replace(cfg, range_detect=False),
         None),
        ("crafted E=2", crafted, dataclasses.replace(cfg, range_extend_cells=2), None),
        ("crafted SO", crafted, dataclasses.replace(cfg, method=1), None),
        ("crafted, notch rows negative, fused", negative, cfg, zero),
        ("crafted, notch rows negative, fused, SO", negative, dataclasses.replace(cfg, method=1),
         zero),
    ]
    max_abs, mismatched = 0.0, 0
    for label, x, c, z in cases:
        kf, kv = kcfar.cascaded_cfar2d(x, c, n_clutter, segments, zero_rows=z)
        pf, pv = kcfar.cascaded_cfar2d_plain(x, c, n_clutter, segments, z)
        torch.cuda.synchronize()
        diff = torch.cat([(kf != pf).flatten(), (kv != pv).flatten()])
        n_diff = int(diff.sum())
        max_abs = max(max_abs, float(diff.float().max()))   # |kernel - plain| of 0/1 flags
        mismatched += n_diff
        print(f"B1 cascaded_cfar2d [{label}] {tuple(x.shape)}: flags "
              f"{int(kf.sum())}/{int(pf.sum())} vflags {int(kv.sum())}/{int(pv.sum())} "
              f"(kernel/plain), {n_diff} differ -> "
              f"{'bit-identical' if n_diff == 0 else 'MISMATCH'}")
    if mismatched:
        fail(f"B1: {mismatched} kernel flags differ from the plain version")
    del crafted, negative

    t0 = time.perf_counter()
    div_bad = kcfar.division_mismatches(dev)
    print(f"B1 division by 5 (FMA sequence) against __fdiv_rn(x, 5.0f) on all 2^32 float32 "
          f"bit patterns: {div_bad} differ ({time.perf_counter() - t0:.3f} s) -> "
          f"{'bit-identical' if div_bad == 0 else 'MISMATCH'}")
    if div_bad:
        fail(f"B1: its division by 5 differs from IEEE division on {div_bad} inputs")

    # detect_rdm on the window copies nothing from the host: no stream sync
    detect_rdm(rdm_b2, prof, n_clutter)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flags_sync, _ = detect_rdm(rdm_b2, prof, n_clutter)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pf, _ = kcfar.cascaded_cfar2d_plain(rdm_b2, cfg, n_clutter, segments, zero)
    if not torch.equal(flags_sync, pf):
        fail("B1: detect_rdm's flags differ from the plain version")
    print("B1 detect_rdm on the G2 window under torch.cuda.set_sync_debug_mode('error'): "
          "enqueued with no stream synchronisation, flags equal to the plain version")

    stats = b1_report("G2, 3 segments, re-notch fused", rdm_b2, cfg, n_clutter,
                      lambda: kcfar.cascaded_cfar2d(rdm_b2, cfg, n_clutter, segments,
                                                    zero_rows=zero),
                      lambda: kcfar.cascaded_cfar2d_plain(rdm_b2, cfg, n_clutter, segments,
                                                          zero),
                      notched_rows=zero[1] - zero[0])
    unfused = b1_report("G2, 3 segments, re-notch product then B1", rdm_b2, cfg, n_clutter,
                        lambda: kcfar.cascaded_cfar2d(rdm_b2 * mask[:, None], cfg, n_clutter,
                                                      segments),
                        lambda: kcfar.cascaded_cfar2d_plain(rdm_b2, cfg, n_clutter, segments,
                                                            zero))
    return {"max_abs_err": max_abs, "mismatched_flags": mismatched, **stats,
            "library_ms": None, "division_mismatches": div_bad,
            "unfused_stage": {k: unfused[k] for k in ("ms", "device_ms", "enqueue_ms",
                                                      "bound_ms")}}


def write_scene(root: str, prof, rng) -> tuple[str, int, int, int]:
    """Seeded 4-frame G2 capture (16-channel int16 DDC) with one point target
    steered to one DBF beam, and the DBF coefficient file.  Returns
    (coeff path, target beam, expected Doppler row, expected range column)."""
    from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
    from radar_signal_process_tpu_torch.sim import write_g2_capture

    n_frames, n_prt, n_pts, n_ch = 4, prof.prt_per_frame, prof.point_prt, prof.n_channels
    # 13 orthogonal DFT beams over the 16-element array, u_b = (b - 6) / 8,
    # with a seeded +-2 degree phase error per coefficient
    u = (np.arange(prof.n_beams) - prof.n_beams // 2) / 8.0
    ch = np.arange(n_ch)
    coeffs = np.exp(-1j * np.pi * u[:, None] * ch[None, :]
                    + 1j * np.deg2rad(rng.uniform(-2, 2, (prof.n_beams, n_ch))))
    coeff_path = os.path.join(root, "dbf_coeffs.txt")
    inter = np.empty((prof.n_beams, 2 * n_ch))
    inter[:, 0::2], inter[:, 1::2] = coeffs.real, coeffs.imag
    np.savetxt(coeff_path, inter)

    beam = int(rng.integers(0, prof.n_beams))
    delay = round(TARGET_R / prof.delta_r)
    col = prof.segment_starts[2] + delay
    pulse = reference_pulses(prof)[2]                 # up-chirp, long segment
    fd = 2.0 * TARGET_V / prof.wavelength
    m = np.arange(n_frames * n_prt).reshape(n_frames, n_prt)
    doppler = np.exp(1j * 2 * np.pi * fd * prof.prt * m)
    steer = np.exp(1j * np.pi * u[beam] * ch)
    iq = np.empty((n_frames, n_prt, n_pts, n_ch), np.complex64)
    for f in range(n_frames):
        noise = rng.normal(0, 100, (n_prt, n_pts, n_ch)) + 1j * rng.normal(
            0, 100, (n_prt, n_pts, n_ch))
        noise[:, col : col + len(pulse), :] += 60.0 * (
            doppler[f][:, None, None] * pulse[None, :, None] * steer[None, None, :])
        iq[f] = np.round(noise)
    write_g2_capture(os.path.join(root, "cap"), iq, prof, data_type=1)
    row = prof.prt_per_frame // 2 + round(fd * prof.prt * prof.prt_per_frame)
    return coeff_path, beam, row, col


def phase_slice(dev) -> dict:
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, detect_rdm, renotch_mask
    from radar_signal_process_tpu_torch.models.mtd_pipeline import slice_cpi_window
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.ops.dbf import apply_dbf, load_dbf_coeffs
    from radar_signal_process_tpu_torch.ops.measure import extract_detections
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu_torch.params import chain_params

    rng = np.random.default_rng(SEED + 2)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        coeff_path, beam, row, col = write_scene(root, prof, rng)
        print(f"slice: wrote 4-frame G2 capture (16 ch, int16 DDC) in "
              f"{time.perf_counter() - t0:.1f} s; target beam {beam} at "
              f"(v {row}, r {col})")
        cap = os.path.join(root, "cap")
        first: dict = {}
        stamps: list = []
        found: list = []
        windows: list = []

        def on_result(res):
            stamps.append(time.perf_counter())
            if not bool(torch.isfinite(res.rdms).all()):
                fail(f"slice: non-finite RDM in window {res.frame_idx}")
            d = res.detections
            hit = (d.valid[beam] & ((d.v_idx[beam] - row).abs() <= 1)
                   & ((d.r_idx[beam] - col).abs() <= 1)).any(dim=-1)
            found.append(hit.cpu().tolist())
            windows.append(res.rdms)
            if not first:
                first.update(idx=res.frame_idx, rdms=res.rdms, flags=res.flags)

        argv = ["stream", "--input", cap, "--profile", "G2", "--frames", "4",
                "--win-size", "4", "--dbf-coeffs", coeff_path, "--emit", "full",
                "--device", dev.type]
        krdm.doppler_rdm.launches = 0
        kcfar.cascaded_cfar2d.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv, on_result=on_result)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                    "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
        if rc != 0 or len(stamps) != 3:
            fail(f"slice: cli stream rc {rc}, {len(stamps)} windows (want 3)")
        if min(launches.values()) < 1:
            fail(f"slice: a kernel did not run on the main path: {launches}")
        # one B1 call a window until the second window captures the window's
        # CUDA graph; later windows replay it
        if launches["cascaded_cfar2d"] != min(len(stamps), 2):
            fail(f"slice: {launches['cascaded_cfar2d']} B1 launches for {len(stamps)} windows")
        if not all(all(w) for w in found):
            fail(f"slice: target not detected in beam {beam} in every slice: {found}")
        rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        reader_cls = g2_reader_class()   # the one the CLI picked by default
        print(f"slice: cli stream ({reader_cls.__name__}) 13 beams x 4 slices x "
              f"332 x 3404: 3 windows in {wall:.2f} s (the first waits for two frame "
              f"parses and cuFFT plan set-up); windows 2-3 at {rate:.2f} windows/s; launches "
              f"{launches}; target found in beam {beam}, every slice of every window")

        # the returned stack against the plain versions on the same frames
        params = chain_params(prof, dbf_coeffs=load_dbf_coeffs(coeff_path, 16), device=dev)
        reader = reader_cls(cap, prof)
        t0 = time.perf_counter()
        frames = [reader.read_frame(i).iq for i in (first["idx"], first["idx"] + 1)]
        parse_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        host = [torch.from_numpy(f).pin_memory() for f in frames]

        def stage(h):
            return apply_dbf(h.to(dev, non_blocking=True), params.dbf).permute(2, 0, 1).contiguous()

        a, b = stage(host[0]), stage(host[1])
        win = torch.cat([a, b], dim=-2)
        pc = slice_cpi_window(segmented_pulse_compression(
            win, prof, params.pc_spectra, params.pc_filter_lens), 4)
        notch = notch_rows(G2_PULSES, prof.mtd.notch_divisor)
        want = krdm.doppler_rdm_plain(pc, params.dft_re, params.dft_im, notch)
        got = first["rdms"]
        # int16-scale data: the GEMM's absolute error scales with the RDM's
        # peak, so the absolute term is relative to it (as the tests do)
        peak = float(want.abs().max())
        rdm_ok = bool(((got - want).abs() <= 2e-5 * peak + RDM_RTOL * want.abs()).all())
        n_clutter = clutter_cells(prof, G2_PULSES)
        keep = torch.from_numpy(renotch_mask(prof, G2_PULSES, n_clutter, 20)).to(dev)
        pf, _ = segmented_cfar(got * keep[:, None], prof.cfar_segments, prof.cfar, n_clutter)
        flags_ok = torch.equal(pf, first["flags"])
        print(f"slice: window {first['idx']} RDM vs plain max_abs_err "
              f"{float((got - want).abs().max()):.3e} (peak {peak:.3e}) -> "
              f"{'ok' if rdm_ok else 'FAIL'}; "
              f"flags vs plain CFAR on the returned RDM -> "
              f"{'bit-identical' if flags_ok else 'MISMATCH'}")
        if not (rdm_ok and flags_ok):
            fail("slice: stream output disagrees with the plain versions")

        rdm = krdm.doppler_rdm(pc, params.dft_re, params.dft_im, notch)
        flags, _ = detect_rdm(rdm, prof, n_clutter)
        ms = cuda_ms({
            "dbf": lambda: stage(host[1]),
            "pc": lambda: segmented_pulse_compression(
                win, prof, params.pc_spectra, params.pc_filter_lens),
            "rdm": lambda: krdm.doppler_rdm(pc, params.dft_re, params.dft_im, notch),
            "cfar": lambda: detect_rdm(rdm, prof, n_clutter),
            "extract": lambda: extract_detections(flags, rdm, 16),
        }, reps=5)
        print("slice: stage median ms (CUDA events, one window; dbf per frame): "
              + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" | sum {sum(ms.values()):.3f} | host .bin parse "
              f"{parse_ms:.1f} ms/frame ({reader_cls.__name__}, wall clock)")
        del first, rdm, flags, pc, want, got
        block = phase_block(dev, cap, coeff_path, beam, row, col, windows)
        mesh = phase_mesh(dev, cap, coeff_path, beam, row, col, windows, (a, b))
    return launches, mesh, block


def counted(module, name: str, calls: list):
    """``module.name`` wrapped to append to ``calls`` on every call, and the
    function that puts the original back (a PC call is one cuFFT pulse
    compression: of a frame in the block path, of a doubled window in
    ``FrameProcessor``)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def phase_block(dev, cap: str, coeff_path: str, beam: int, row: int, col: int,
                windows: list) -> dict:
    """The block path on the card (``models/host_parallel.py``): (a) the
    slice capture through ``StreamingPipeline(use_host_parallel=True,
    block_windows=2)``, against the windowed stream's windows; (b) 13 seeded
    G2 beam frames in device memory through ``make_stream_pipeline`` (K = 6)
    against ``FrameProcessor`` + ``Detector`` window by window, timed, and
    B2 at the first block's batch against its plain version; (c)
    ``make_stream_processor`` over three frame pairs; (d) ``make_flags`` over
    a G2 stack; (e) the native C++ cascade on the card's host against B1."""
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.ingest import g2_reader_class
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models import host_parallel as hp
    from radar_signal_process_tpu_torch.models import mtd_pipeline as tmtd
    from radar_signal_process_tpu_torch.models.detect import (
        clutter_cells,
        make_cascade_detector,
        make_detector,
        renotch_mask,
    )
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.ops.dbf import load_dbf_coeffs

    n_clutter = clutter_cells(prof, G2_PULSES)
    keep = torch.from_numpy(renotch_mask(prof, G2_PULSES, n_clutter, 20)).to(dev)
    cfg, segments = prof.cfar, prof.cfar_segments
    pc_calls: list = []
    restore = [counted(hp, "segmented_pulse_compression", pc_calls),
               counted(tmtd, "segmented_pulse_compression", pc_calls)]

    def zero():
        krdm.doppler_rdm.launches = kcfar.cascaded_cfar2d.launches = 0
        pc_calls.clear()

    def read():
        return {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches, "pc": len(pc_calls)}

    def within(got, want):
        peak = float(want.abs().max())
        return bool(((got - want).abs() <= 2e-5 * peak + RDM_RTOL * want.abs()).all())

    def plain_diff(rdms, flags):
        return int((segmented_cfar(rdms * keep[:, None], segments, cfg, n_clutter)[0]
                    != flags).sum())

    try:
        # (a) the slice capture, blocks of 2 and 1 windows
        coeffs = load_dbf_coeffs(coeff_path, prof.n_channels)
        reader_cls = g2_reader_class()

        def drive(emit):
            pipe = StreamingPipeline(reader_cls(cap, prof), prof, win_size=4, max_frames=4,
                                     dbf_coeffs=coeffs, emit=emit, device=dev,
                                     use_host_parallel=True, block_windows=2)
            zero()
            t0 = time.perf_counter()
            out = list(pipe)
            torch.cuda.synchronize()
            return out, read(), time.perf_counter() - t0

        full, launches_a, wall = drive("full")
        if [r.frame_idx for r in full] != [0, 1, 2]:
            fail(f"block: windows {[r.frame_idx for r in full]} (want 0, 1, 2)")
        if launches_a != {"doppler_rdm": 2, "cascaded_cfar2d": 2, "pc": 4}:
            fail(f"block: launches {launches_a} (want B2 2, B1 2, PC 4)")
        worst, bit, n_diff, found = 0.0, True, 0, []
        for r, want in zip(full, windows):
            if not (bool(torch.isfinite(r.rdms).all()) and within(r.rdms, want)):
                fail(f"block: window {r.frame_idx} RDMs off the windowed stream's")
            worst = max(worst, float((r.rdms - want).abs().max()))
            bit = bit and torch.equal(r.rdms, want)
            n_diff += plain_diff(r.rdms, r.flags)
            d = r.detections
            found.append((d.valid[beam] & ((d.v_idx[beam] - row).abs() <= 1)
                          & ((d.r_idx[beam] - col).abs() <= 1)).any(dim=-1).cpu().tolist())
        print(f"block (a): StreamingPipeline(use_host_parallel=True, block_windows=2) over the "
              f"slice capture ({reader_cls.__name__}, seeded DBF): windows 0, 1, 2 in "
              f"{wall:.2f} s; "
              f"launches {launches_a}; RDMs vs the windowed stream max_abs_err {worst:.3e} "
              f"(2e-5*peak + {RDM_RTOL}*|want|) -> ok, bit-identical: {bit}; flags vs the "
              f"plain CFAR on the block's RDMs: {n_diff} differ -> "
              f"{'bit-identical' if n_diff == 0 else 'MISMATCH'}; target in beam {beam}: {found}")
        if n_diff or not all(all(w) for w in found):
            fail("block: flags differ from the plain CFAR or the target is missing")
        det, launches_d, _ = drive("detections")
        same = len(det) == len(full) and all(
            g.rdms is None and g.flags is None and g.cfar_hits == f.cfar_hits
            and all(torch.equal(x, y) for x, y in zip(g.detections, f.detections))
            for g, f in zip(det, full))
        print(f"block (a): emit='detections': launches {launches_d}; detections and hits equal "
              f"to emit='full' -> {'ok' if same else 'MISMATCH'}")
        if not same:
            fail("block: emit='detections' differs from emit='full'")
        del full, det

        # (b) 13 G2 beam frames on the card, blocks of K = 6
        k, n_frames = 6, 13
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 7)
        frames = [torch.randn((prof.n_beams, G2_PULSES, G2_RANGE), dtype=torch.complex64,
                              device=dev, generator=gen) for _ in range(n_frames)]
        n_win = n_frames - 1
        run = hp.make_stream_pipeline(prof, 4, n_clutter, max_detections=16, device=dev)
        processor = tmtd.make_frame_processor(prof, 4, device=dev)
        detector = make_detector(prof, n_clutter=n_clutter, max_detections=16, device=dev)

        def block_form(sink):
            carry = None
            for b0 in range(0, n_win, k):
                carry = run(frames[b0 : b0 + k + 1],
                            lambda w, *r, b0=b0: sink(b0 + w, *r), carry=carry)

        def windowed_form(sink):
            for w in range(n_win):
                rdms = processor(frames[w], frames[w + 1])
                flags, _, dets = detector(rdms)
                sink(w, rdms, flags, dets, int(flags.sum()))

        got_b, got_w = {}, {}
        forms = {"block": (block_form, got_b), "windowed": (windowed_form, got_w)}
        counts = {}
        # the inputs of the first block's B2 launch (K windows at once), to
        # hold B2 against its plain version at the block's batch
        b2_args: list = []
        real_b2 = tmtd.doppler_rdm

        def capture_b2(*args):
            if not b2_args:
                b2_args.extend(args)
            return real_b2(*args)

        with torch.inference_mode():
            for name, (form, got) in forms.items():
                zero()
                tmtd.doppler_rdm = capture_b2 if name == "block" else real_b2
                try:
                    form(lambda w, *r, got=got: got.__setitem__(w, r[:3]))
                finally:
                    tmtd.doppler_rdm = real_b2
                torch.cuda.synchronize()
                counts[name] = read()
            want_b2 = krdm.doppler_rdm_plain(*b2_args)
            got_b2 = torch.stack([got_b[w][0] for w in range(k)])
            b2_batch = int(np.prod(want_b2.shape[:-2]))
            if want_b2.shape != got_b2.shape or not within(got_b2, want_b2):
                fail(f"block (b): B2 at batch {b2_batch} off its plain version")
            b2_err = float((got_b2 - want_b2).abs().max())
            del b2_args[:], want_b2, got_b2
            worst, n_diff, bit = 0.0, 0, True
            for w in range(n_win):
                rb, fb, _ = got_b[w]
                rw = got_w[w][0]
                if not within(rb, rw):
                    fail(f"block (b): window {w} RDMs off FrameProcessor's")
                worst = max(worst, float((rb - rw).abs().max()))
                bit = bit and torch.equal(rb, rw)
                n_diff += plain_diff(rb, fb)
            if n_diff:
                fail(f"block (b): {n_diff} flags differ from the plain CFAR on the block's RDMs")
            del got_b, got_w
            # each turn drops its results as they come, so the peak is the
            # form's working set over the frames
            times, peaks = {"block": [], "windowed": []}, {"block": [], "windowed": []}
            for name in ("block", "windowed", "windowed", "block", "block", "windowed"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                forms[name][0](lambda *r: None)
                b.record()
                b.synchronize()
                times[name].append(a.elapsed_time(b) / n_win)
                peaks[name].append((torch.cuda.max_memory_allocated(dev) - base) / 1e6)
        ms = {name: float(np.median(v)) for name, v in times.items()}
        peaks = {name: float(np.median(v)) for name, v in peaks.items()}
        per_win = {name: {key: c[key] / n_win for key in c} for name, c in counts.items()}
        print(f"block (b): {n_frames} G2 beam frames ({prof.n_beams} x {G2_PULSES} x {G2_RANGE}, "
              f"{sum(f.numel() * 8 for f in frames) / 1e9:.2f} GB on the card), {n_win} "
              f"windows: B2 at the first block's batch ({b2_batch} RDMs) vs its plain version "
              f"on the same inputs max_abs_err {b2_err:.3e} (2e-5*peak + {RDM_RTOL}*|want|) "
              f"-> ok; RDMs block vs FrameProcessor max_abs_err {worst:.3e} -> ok, "
              f"bit-identical: {bit}; flags vs the plain CFAR on the block's RDMs: 0 differ | "
              f"device ms per window (CUDA events, median of 3, in turns): block (K = {k}) "
              f"{ms['block']:.3f}, windowed {ms['windowed']:.3f} | launches per window: "
              f"block {per_win['block']}, windowed {per_win['windowed']} | peak memory above "
              f"the frames (max_memory_allocated): block {peaks['block']:.0f} MB, windowed "
              f"{peaks['windowed']:.0f} MB | {SMI['line']}")

        # (c) make_stream_processor over three consecutive frame pairs
        proc = hp.make_stream_processor(prof, 4, device=dev)
        zero()
        with torch.inference_mode():
            outs = [proc(frames[w], frames[w + 1], frame_idx=w) for w in range(3)]
            torch.cuda.synchronize()
            launches_c = read()
            ok_c = all(within(o, processor(frames[w], frames[w + 1]))
                       for w, o in enumerate(outs))
        print(f"block (c): make_stream_processor over 3 consecutive G2 frame pairs: launches "
              f"{launches_c} (PC once per frame); RDMs vs FrameProcessor -> "
              f"{'ok' if ok_c else 'FAIL'}")
        if launches_c["pc"] != 4 or launches_c["doppler_rdm"] != 3 or not ok_c:
            fail("block (c): make_stream_processor launches or RDMs wrong")

        # (d) make_flags over a G2 stack: one B1 launch, the detector's flags
        with torch.inference_mode():
            zero()
            flags, _ = hp.make_flags(prof, n_clutter, device=dev)(outs[-1])
            torch.cuda.synchronize()
            launches_d_flags = read()
            want_flags = detector(outs[-1])[0]
            n_diff_d = int((flags != want_flags).sum())
        print(f"block (d): make_flags over a G2 stack {tuple(outs[-1].shape)}: launches "
              f"{launches_d_flags}; flags vs the detector's: {n_diff_d} differ")
        if launches_d_flags["cascaded_cfar2d"] != 1 or n_diff_d:
            fail("block (d): make_flags is not one B1 launch or its flags differ")

        # (e) the native cascade on the card's host, one transposed window
        from radar_signal_process_tpu_torch.kernels import native_cfar

        stale = native_cfar.lib_path()
        if os.path.exists(stale):      # always build from this checkout's source
            os.unlink(stale)
        t0 = time.perf_counter()
        if not native_cfar.native_cfar_available():
            fail(f"block (e): native CFAR unavailable: {native_cfar.build_error()}")
        build_s = time.perf_counter() - t0
        one = native_cfar.make_native_cascade(
            n_clutter, cfg, segments=segments,
            notch_mask=native_cfar.notch_mask_shifted(G2_PULSES, 20))
        rdm_t = outs[-1].reshape(-1, G2_PULSES, G2_RANGE).mT.contiguous().cpu()
        b1 = want_flags.reshape(-1, G2_PULSES, G2_RANGE).cpu()
        t0 = time.perf_counter()
        native = [one(r)[0] for r in rdm_t]
        native_ms = (time.perf_counter() - t0) * 1e3 / len(native)
        n_diff_e = int((torch.stack(native).mT != b1).sum())
        # as the CPU block path runs it: the RDMs on a pool of host threads
        pooled = make_cascade_detector(prof, n_clutter, transposed=True, device="cpu")
        t0 = time.perf_counter()
        pooled_flags = pooled(rdm_t)[0]
        pool_ms = (time.perf_counter() - t0) * 1e3 / len(native)
        n_diff_e += int((pooled_flags.mT != b1).sum())
        print(f"block (e): native C++ cascade (g++ build {build_s:.1f} s) on one transposed G2 "
              f"window {tuple(rdm_t.shape)}: {native_ms:.2f} ms per RDM on the host on one "
              f"thread, {pool_ms:.2f} through make_cascade_detector's pool "
              f"(os.cpu_count() {os.cpu_count()}); flags of both vs B1: {n_diff_e} differ -> "
              f"{'bit-identical' if n_diff_e == 0 else 'MISMATCH'}")
        if n_diff_e:
            fail("block (e): the native cascade differs from B1")
    finally:
        for r in restore:
            r()
    return {"launches": {"stream block": launches_a, "stream block detections": launches_d,
                         "make_stream_pipeline": counts["block"],
                         "make_stream_processor": launches_c, "make_flags": launches_d_flags},
            "window_ms": ms, "launches_per_window": per_win, "peak_mb": peaks,
            "b2_block_batch": b2_batch, "b2_block_max_abs_err": b2_err,
            "native_ms_per_rdm": native_ms, "native_pool_ms_per_rdm": pool_ms,
            "host_cpus": os.cpu_count()}


def phase_mesh(dev, cap: str, coeff_path: str, beam: int, row: int, col: int,
               windows: list, frames: tuple) -> dict:
    """``cli stream --mesh 1x1`` over the slice phase's capture: an NCCL
    group of one formed by ``initialize_distributed``, the sharded stream
    (B2 and B1 once per window; at sp = 1 B1 runs on the rank's block as it
    is), each window's RDMs within the slice's tolerance of the unsharded
    stream's, its flags equal to B1's plain version (``segmented_cfar``) on
    the returned RDM, the target in every slice; the device time of a
    window, sharded and unsharded; then B1 on the halo-extended blocks of sp
    = 2 and 4 shards (:func:`mesh_b1_blocks`)."""
    import torch.distributed as dist

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models.detect import (
        clutter_cells,
        renotch_mask,
        renotch_rows,
    )
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar

    n_clutter = clutter_cells(prof, G2_PULSES)
    keep = torch.from_numpy(renotch_mask(prof, G2_PULSES, n_clutter, 20)).to(dev)
    cfg, segments = prof.cfar, prof.cfar_segments
    got: list = []
    found: list = []
    group: dict = {}

    def on_result(res):
        if not group:      # the group is up while the stream runs
            one = torch.ones(1, device=dev)
            dist.all_reduce(one)
            group.update(backend=dist.get_backend(), world=dist.get_world_size(),
                         all_reduce=float(one))
        d = res.detections
        hit = (d.valid[beam] & ((d.v_idx[beam] - row).abs() <= 1)
               & ((d.r_idx[beam] - col).abs() <= 1)).any(dim=-1)
        found.append(hit.cpu().tolist())
        got.append((res.rdms, res.flags))

    argv = ["stream", "--input", cap, "--profile", "G2", "--frames", "4", "--win-size", "4",
            "--dbf-coeffs", coeff_path, "--emit", "full", "--device", dev.type, "--mesh", "1x1"]
    krdm.doppler_rdm.launches = 0
    kcfar.cascaded_cfar2d.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv, on_result=on_result)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    if rc != 0 or len(got) != len(windows) or dist.is_initialized():
        fail(f"mesh: cli stream --mesh 1x1 rc {rc}, {len(got)} windows (want {len(windows)}), "
             f"group left {'up' if dist.is_initialized() else 'down'}")
    backend = {"cuda": "nccl", "cpu": "gloo"}[dev.type]
    if group != {"backend": backend, "world": 1, "all_reduce": 1.0}:
        fail(f"mesh: process group {group} (want {backend}, world 1)")
    if launches != {"doppler_rdm": len(got), "cascaded_cfar2d": len(got)}:
        fail(f"mesh: launches {launches} (want B2 and B1 once per window)")
    if not all(all(w) for w in found):
        fail(f"mesh: target not detected in beam {beam} in every slice: {found}")
    worst, n_diff = 0.0, 0
    for (rdm, flags), want in zip(got, windows):
        peak = float(want.abs().max())
        err = (rdm - want).abs()
        if not bool((err <= 2e-5 * peak + RDM_RTOL * want.abs()).all()):
            fail("mesh: sharded stream RDMs off the unsharded stream's")
        worst = max(worst, float(err.max()))
        plain, _ = segmented_cfar(rdm * keep[:, None], segments, cfg, n_clutter)
        n_diff += int((plain != flags).sum())
    print(f"mesh: cli stream --mesh 1x1 ({group['backend']} group of {group['world']}, "
          f"all_reduce ok) 13 beams x 4 slices x 332 x 3404: {len(got)} windows in {wall:.2f} s; "
          f"launches {launches}; RDMs vs the unsharded stream max_abs_err {worst:.3e} "
          f"(2e-5*peak + {RDM_RTOL}*|want|) -> ok; flags vs the plain CFAR on the returned RDMs: "
          f"{n_diff} differ -> {'bit-identical' if n_diff == 0 else 'MISMATCH'}; target found "
          f"in beam {beam}, every slice of every window")
    if n_diff:
        fail(f"mesh: {n_diff} flags of the sharded stream differ from the plain CFAR on its RDMs")
    del got, windows

    # device time of one window: the sharded step (one frame compressed, the
    # other carried) against the unsharded processor + detector
    rdm_ms = _mesh_times(dev, prof, n_clutter, frames)

    # B1 on the halo-extended blocks of sp shards, stitched, against the
    # plain version and B1 on the whole RDM
    route = mesh_b1_blocks(rdm_ms.pop("rdm").reshape(-1, G2_PULSES, G2_RANGE).contiguous(),
                           keep, renotch_rows(prof, G2_PULSES, n_clutter, 20), cfg, segments,
                           n_clutter)
    return {"launches": launches, "window_ms": rdm_ms, "b1_blocks": route}


def mesh_b1_blocks(raw: torch.Tensor, keep: torch.Tensor, zero: tuple, cfg, segments,
                   n_clutter: int) -> dict:
    """B1 on the halo-extended blocks of sp = 2 and 4 range shards of the G2
    window ``raw`` (before the CFAR stage's re-notch), in the form the
    sharded CFAR runs (``extended_block_cfar`` with the re-notch rows
    ``zero`` read as 0.0), centres stitched, bit for bit against the plain
    version on ``raw * keep`` and B1 on the whole window; its device time a
    window beside the byte floor of its blocks."""
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.parallel.sharding import extended_block_cfar

    rdm = raw * keep[:, None]
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    plain_f, plain_v = segmented_cfar(rdm, segments, cfg, n_clutter)
    whole_f, whole_v = kcfar.cascaded_cfar2d(raw, cfg, n_clutter, segments, zero_rows=zero)
    if not (torch.equal(whole_f, plain_f) and torch.equal(whole_v, plain_v)):
        fail("mesh: B1 on the whole G2 window differs from its plain version")
    route = {}
    for sp in (2, 4):
        # each block as halo_exchange delivers it to sharded_cascaded_cfar2d:
        # the right halo wider by the columns that make a row whole 16 bytes,
        # so TMA stages it
        local = G2_RANGE // sp
        w = local + 2 * h + -(local + 2 * h) % 4
        ext = torch.cat([raw[..., -h:], raw, raw[..., : w - local - h]], dim=-1)
        blocks = [(s * local, ext[..., s * local : s * local + w].contiguous())
                  for s in range(sp)]

        def run(blocks=blocks, local=local):
            return [extended_block_cfar(blk, cfg, n_clutter, G2_RANGE, segments, c0, local, h,
                                        zero_rows=zero)
                    for c0, blk in blocks]

        parts = run()
        got_f, got_v = torch.cat([f for f, _ in parts], -1), torch.cat([v for _, v in parts], -1)
        n_diff = int((got_f != plain_f).sum() + (got_v != plain_v).sum()
                     + (got_f != whole_f).sum() + (got_v != whole_v).sum())
        ms = cuda_ms({"blocks": run, "whole": lambda: kcfar.cascaded_cfar2d(
            raw, cfg, n_clutter, segments, zero_rows=zero)})
        dev_ms = graph_ms(run)
        bound = sum(cost_model.cascaded_cfar_cost(
            blk.shape[0], G2_PULSES, blk.shape[-1], n_clutter, cfg,
            notched_rows=zero[1] - zero[0])["sol_s"] for _, blk in blocks) * 1e3
        route[sp] = {"mismatched_flags": n_diff, "blocks_ms": ms["blocks"],
                     "whole_ms": ms["whole"], "device_ms": dev_ms, "bound_ms": bound,
                     "block_shape": list(blocks[0][1].shape)}
        print(f"mesh: B1 on the {sp} halo-extended blocks {tuple(blocks[0][1].shape)} of a "
              f"full-G2 window (shards cut the segments, re-notch rows {zero} fused), centres "
              f"stitched vs the plain CFAR and B1 on the whole {tuple(raw.shape)}: {n_diff} "
              f"flags differ -> {'bit-identical' if n_diff == 0 else 'MISMATCH'}; median ms "
              f"(CUDA events) {sp} block calls {ms['blocks']:.4f}, whole {ms['whole']:.4f}; "
              f"device {dev_ms:.4f} ms a window (CUDA graph of 20), byte floor {bound:.4f} ms "
              f"= {100 * bound / dev_ms:.1f}% | {SMI['line']}")
        if n_diff:
            fail(f"mesh: B1 on sp={sp} extended blocks differs from the whole RDM's flags")
    return route


def _mesh_times(dev, prof, n_clutter: int, frames: tuple) -> dict:
    """Device ms of one G2 window (CUDA events, in turns): the world-1
    sharded step plus detection extraction, and the unsharded frame
    processor plus detector, on the same two DBF'd frames."""
    import torch.distributed as dist

    from radar_signal_process_tpu_torch.models.detect import make_detector
    from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor
    from radar_signal_process_tpu_torch.ops.measure import extract_detections
    from radar_signal_process_tpu_torch.parallel import make_mesh
    from radar_signal_process_tpu_torch.parallel.multihost import initialize_distributed
    from radar_signal_process_tpu_torch.parallel.sharding import make_sharded_stream

    a, b = frames
    initialize_distributed(dev.type)
    try:
        mesh = make_mesh(("dp", "sp"), (1, 1), dev.type)
        compress, step = make_sharded_stream(prof, mesh, n_clutter=n_clutter, win_size=4,
                                             renotch_divisor=20)
        processor = make_frame_processor(prof, 4, device=dev)
        detector = make_detector(prof, n_clutter=n_clutter, max_detections=16, device=dev)
        pc = compress(a)

        def sharded():
            _, rdm, flags, _ = step(pc, b)
            return extract_detections(flags, rdm, 16)

        with torch.inference_mode():
            ms = cuda_ms({"sharded": sharded, "unsharded": lambda: detector(processor(a, b))},
                         reps=5)
            rdm = step(pc, b)[1]
    finally:
        dist.destroy_process_group()
    print(f"mesh: one G2 window, device ms (CUDA events, median of 5, in turns): world-1 "
          f"sharded step + extract {ms['sharded']:.3f} (one frame compressed, one carried), "
          f"unsharded processor + detector {ms['unsharded']:.3f} | {SMI['line']}")
    return {**ms, "rdm": rdm}


def rdm_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max |got - want|, max relative error, peak |want|)."""
    err = (got - want).abs()
    return (float(err.max()), float((err / want.abs().clamp_min(1e-30)).max()),
            float(want.abs().max()))


def phase_pc_rdm(dev, chain) -> tuple[dict, tuple[torch.Tensor, torch.Tensor]]:
    from radar_signal_process_tpu_torch.kernels.pc_rdm import (
        fused_pc_rdm,
        fused_pc_rdm_plain,
        pc_operator_image,
    )

    prof = chain.profile
    rng = np.random.default_rng(SEED + 3)
    shape = (G0_BATCH, prof.prt_per_frame, prof.point_prt)
    x = np.empty(shape, np.complex64)
    x.real = rng.standard_normal(shape, dtype=np.float32)
    x.imag = rng.standard_normal(shape, dtype=np.float32)
    beams = torch.from_numpy(x).to(dev)
    ps = prof.segment_points[0]
    segments = {
        "short": (beams[..., :ps], chain.pc_short_re, chain.pc_short_im),
        "long": (beams[..., ps:], chain.pc_long_re, chain.pc_long_im),
    }
    ffts = chain.front_fft(beams)
    outs, fns, errs, c128_errs = [], {}, {}, {}
    ok = True
    for (name, (seg, m_re, m_im)), fft in zip(segments.items(), ffts):
        def run_kernel(seg=seg, m_re=m_re, m_im=m_im):
            return fused_pc_rdm(seg, m_re, m_im, chain.dft_re, chain.dft_im)

        def run_plain(seg=seg, m_re=m_re, m_im=m_im):
            return fused_pc_rdm_plain(seg, m_re, m_im, chain.dft_re, chain.dft_im)

        got, want = run_kernel(), run_plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"B3 {name}: bad output shape {tuple(got.shape)} or non-finite values")
        max_abs, max_rel, peak = rdm_error(got, want)
        seg_ok = bool(((got - want).abs() <= 2e-5 * peak + 2e-4 * want.abs()).all())
        fft_abs, _, fft_peak = rdm_error(got, fft)
        fft_ok = fft_abs <= 5e-5 * fft_peak
        c128 = torch.complex128
        exact = torch.matmul(
            torch.complex(chain.dft_re, chain.dft_im).to(c128),
            torch.matmul(seg.to(c128), torch.complex(m_re, m_im).to(c128))).abs()
        c128_errs[name] = (c128_error(got, exact), c128_error(want, exact))
        del exact
        ok = ok and seg_ok and fft_ok and c128_errs[name][0] <= C128_PEAK
        errs[name] = (max_abs, max_rel, peak, fft_abs / fft_peak, seg_ok, fft_ok)
        fns[f"{name}_kernel"], fns[f"{name}_plain"] = run_kernel, run_plain
        outs.append(got)
        del want
    fns["cufft_both"] = lambda: chain.front_fft(beams)
    ms = cuda_ms(fns)
    # device time of each segment (a CUDA graph of 20 calls) beside its bound;
    # the cuFFT form copies a filter spectrum from the host, so its call time
    cufft = cuda_ms({name: lambda name=name: chain.front_fft(beams, (name,)) for name in segments})
    device = {}
    for name, (seg, m_re, m_im) in segments.items():
        c = cost_model.fused_pc_rdm_cost(G0_BATCH, prof.prt_per_frame, *m_re.shape,
                                         chain.dft_re.shape[0])
        device[name] = {
            "kernel": graph_ms(fns[f"{name}_kernel"]), "plain": graph_ms(fns[f"{name}_plain"]),
            "cufft": cufft[name],
            "prep": graph_ms(lambda m_re=m_re, m_im=m_im: pc_operator_image(m_re, m_im)),
            "bound": c["sol_s"] * 1e3, "bound_by": c["bound_by"]}
        d = device[name]
        print(f"B3 [{name}] device ms (CUDA graph of 20 calls): kernel {d['kernel']:.4f}, plain "
              f"(two cuBLAS CGEMMs + abs) {d['plain']:.4f}, cuFFT form {d['cufft']:.4f} a call; bound "
              f"{d['bound']:.4f} by {d['bound_by']}, kernel at {100 * d['bound'] / d['kernel']:.1f}% "
              f"of it; the operator's image (once an operator) {d['prep']:.4f} | {SMI['line']}")
    for name, (max_abs, max_rel, peak, fft_rel, seg_ok, fft_ok) in errs.items():
        seg = segments[name][0]
        print(f"B3 fused_pc_rdm [{name}] {tuple(seg.shape)} in place (row stride "
              f"{seg.stride(-2)}) -> {tuple(outs[0 if name == 'short' else 1].shape)}: "
              f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} (peak {peak:.3e}) vs plain "
              f"(2e-5*peak + 2e-4*|want|) -> {'ok' if seg_ok else 'FAIL'}; vs cuFFT "
              f"{fft_rel:.3e}*peak (<= 5e-5) -> {'ok' if fft_ok else 'FAIL'}; vs complex128 "
              f"product: max error / peak kernel {c128_errs[name][0]:.3e} plain "
              f"{c128_errs[name][1]:.3e} (kernel <= {C128_PEAK}) -> "
              f"{'ok' if c128_errs[name][0] <= C128_PEAK else 'FAIL'}; median ms "
              f"kernel {ms[f'{name}_kernel']:.3f} plain {ms[f'{name}_plain']:.3f}")
    kernel_ms = ms["short_kernel"] + ms["long_kernel"]
    plain_ms = ms["short_plain"] + ms["long_plain"]
    costs = [cost_model.fused_pc_rdm_cost(G0_BATCH, prof.prt_per_frame, *m_re.shape,
                                          chain.dft_re.shape[0])
             for _, m_re, _ in segments.values()]
    n_bytes = sum(c["hbm_bytes"] for c in costs)
    tf32_flops = sum(c["flops"] for c in costs)
    c = cost_model.roofline(n_bytes, tf32_flops, cost_model.H100_TF32_FLOPS)
    bound, bound_by = c["sol_s"] * 1e3, c["bound_by"]
    flops = tf32_flops / cost_model.TF32_SPLIT
    print(f"B3 bound per frame (both segments, kernels/cost_model.py): {bound:.3f} ms by "
          f"{bound_by} (3xTF32: {tf32_flops:.3e} TF32 flops at 495 TFLOP/s; "
          f"{n_bytes / 1e6:.1f} MB; the FP32 route's bound "
          f"{flops / cost_model.H100_FP32_FLOPS * 1e3:.3f} ms) | {SMI['line']}")
    print(f"B3 per frame (both segments): kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cuFFT form {ms['cufft_both']:.3f} ms (median of {REPS}, CUDA events); device "
          f"kernel {sum(d['kernel'] for d in device.values()):.4f} ms "
          f"({100 * bound / sum(d['kernel'] for d in device.values()):.1f}% of the bound), plain "
          f"{sum(d['plain'] for d in device.values()):.4f}")
    if not ok:
        fail("B3: kernel disagrees with its plain version, its cuFFT form or the "
             "complex128 product")
    return {"max_abs_err": max(e[0] for e in errs.values()),
            "max_rel_err": max(e[1] for e in errs.values()),
            "error_vs_c128": max(e[0] for e in c128_errs.values()),
            "plain_error_vs_c128": max(e[1] for e in c128_errs.values()),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": None, "cufft_ms": ms["cufft_both"],
            "ms_by_segment": {k: ms[f"{k}_kernel"] for k in segments},
            "plain_ms_by_segment": {k: ms[f"{k}_plain"] for k in segments},
            "device_ms_by_segment": device}, tuple(outs)


def phase_cfar_g0(dev, chain, abs_rdms) -> dict:
    from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d, cfar_plan
    from radar_signal_process_tpu_torch.ops.cfar import cascaded_cfar2d as plain_cfar
    from radar_signal_process_tpu_torch.ops.mtd import zero_velocity_notch_unshifted

    n_clutter = chain.n_clutter
    cfg = chain.profile.cfar
    sums = [zero_velocity_notch_unshifted(a[0] + a[1], n_clutter) for a in abs_rdms]
    rng = np.random.default_rng(SEED + 4)
    cases = [(f"B3 sum {name}, notched", x) for name, x in zip(("short", "long"), sums)]
    for nr in (62, 512):
        crafted = crafted_rdm((1, 2048, nr), rng, n_clutter, ((0, nr),), unshifted=True)
        cases.append((f"crafted {nr} columns", torch.from_numpy(crafted[0]).to(dev)))
    max_abs, mismatched = 0.0, 0
    for label, x in cases:
        kf, kv = cascaded_cfar2d(x, cfg, n_clutter)
        pf, pv = plain_cfar(x, cfg, n_clutter)
        torch.cuda.synchronize()
        diff = torch.cat([(kf != pf).flatten(), (kv != pv).flatten()])
        n_diff = int(diff.sum())
        max_abs = max(max_abs, float(diff.float().max()))
        mismatched += n_diff
        print(f"B1 cascaded_cfar2d G0 [{label}] {tuple(x.shape)} n_clutter {n_clutter}: flags "
              f"{int(kf.sum())}/{int(pf.sum())} vflags {int(kv.sum())}/{int(pv.sum())} "
              f"(kernel/plain), {n_diff} differ -> "
              f"{'bit-identical' if n_diff == 0 else 'MISMATCH'}")
    if mismatched:
        fail(f"B1 at G0: {mismatched} kernel flags differ from the plain version")
    for name, x in zip(("short", "long"), sums):
        plan = cfar_plan(((0, x.shape[-1]),), x.shape[-2] - 2 * n_clutter - 1, 1, cfg)
        print(f"B1 G0 {name} plan: "
              f"{'the narrow body' if plan.narrow else f'tiles of {plan.sw} columns'}, bands of "
              f"{plan.band_rows} rows, {plan.n_blocks} blocks of {plan.threads} threads, "
              f"staging by {'TMA' if plan.tma else 'cp.async'}")
    by_seg = {name: b1_report(f"G0 {name}", x, cfg, n_clutter,
                              lambda x=x: cascaded_cfar2d(x, cfg, n_clutter),
                              lambda x=x: plain_cfar(x, cfg, n_clutter))
              for name, x in zip(("short", "long"), sums)}
    return {"max_abs_err": max_abs, "mismatched_flags": mismatched,
            **{k: sum(v[k] for v in by_seg.values())
               for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bytes")},
            "by_segment": by_seg}


def write_g0_scene(root: str, prof, chain_cfg, rng) -> tuple[float, float]:
    """Seeded 4-frame G1 capture with the known-good G0 target: fd = -60
    Doppler bins, long-pulse cell 100, short-pulse cell 20, right beam 0.8 x
    left, int-rounded at x5000, per-frame frequency index and beam position.
    Returns (Doppler shift [Hz], true long-pulse range [m])."""
    from radar_signal_process_tpu_torch.ops.waveforms import reference_pulses
    from radar_signal_process_tpu_torch.sim import write_g1_capture

    n_frames, n = len(G0_FREQ_INDEX), prof.prt_per_frame
    fd = -60 * prof.prf / chain_cfg.mtd_fft_length
    p_short, p_long = reference_pulses(prof)
    s0, s1 = prof.segment_starts
    m = np.arange(n_frames * n).reshape(n_frames, n)
    ramp = np.exp(1j * 2 * np.pi * fd * m * prof.prt)
    base = np.zeros((n_frames, n, prof.point_prt), complex)
    base[:, :, s0 + 20 : s0 + 20 + len(p_short)] += ramp[..., None] * p_short
    base[:, :, s1 + 100 : s1 + 100 + len(p_long)] += ramp[..., None] * p_long
    noise = rng.normal(0, 2.0, (2, 2) + base.shape)
    left = np.round(5000 * base.real + noise[0, 0]) + 1j * np.round(5000 * base.imag + noise[0, 1])
    right = np.round(4000 * base.real + noise[1, 0]) + 1j * np.round(4000 * base.imag + noise[1, 1])
    write_g1_capture(root, left, right, frames_per_file=10, angle_deg=100.0,
                     freq_index=list(G0_FREQ_INDEX), beam_pos=list(G0_BEAM_POS))
    r_true = 100 * prof.delta_r + chain_cfg.r_sys_err_long - chain_cfg.r_measure_err_long
    return fd, r_true


def g0_kernel_calls(frames) -> int:
    """Calls of B3, and of B1, that a G0 chain on the card makes over
    ``frames`` ((freq_index, beam_pos) in order): one a segment on the first
    frame of each n_clutter, which runs eagerly, and on its second, which
    captures the frame's graph; none on a replay."""
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    chain = G0Chain(device="cpu")
    keys = [chain.frame_params(fi, bp)[1] for fi, bp in frames]
    return 2 * sum(min(keys.count(k), 2) for k in set(keys))


def phase_g0_slice(dev) -> dict:
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G0_PROFILE as prof
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.ingest import g1_reader_class
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
    from radar_signal_process_tpu_torch.models.g0_chain import C_LIGHT, G0Chain
    from radar_signal_process_tpu_torch.ops.cfar import cascaded_cfar2d as plain_cfar
    from radar_signal_process_tpu_torch.ops.measure import extract_detections, motion_parameters
    from radar_signal_process_tpu_torch.ops.mtd import zero_velocity_notch_unshifted
    from radar_signal_process_tpu_torch.ops.tables import freq_value

    chain_cfg = G0ChainConfig()
    rng = np.random.default_rng(SEED + 5)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        fd, r_true = write_g0_scene(root, prof, chain_cfg, rng)
        print(f"G0: wrote {len(G0_FREQ_INDEX)}-frame G1 capture (2 beams x 1536 x 566, 24-bit) "
              f"in {time.perf_counter() - t0:.1f} s; target fd {fd:.2f} Hz, long range "
              f"{r_true:.2f} m, freq index per frame {list(G0_FREQ_INDEX)}")
        stamps: list = []
        first: dict = {}
        found: list = []

        def on_result(frame_idx, res):
            stamps.append(time.perf_counter())
            for t in (res.rdm_sum_short, res.rdm_sum_long, res.rdm_diff_short, res.rdm_diff_long):
                if not bool(torch.isfinite(t).all()):
                    fail(f"G0: non-finite RDM in frame {frame_idx}")
            fi = G0_FREQ_INDEX[frame_idx - 1]
            v_true = -(C_LIGHT / freq_value(fi)) * fd / 2.0
            m = res.measurements_long
            if not bool(m.valid[0]):
                fail(f"G0: no long-pulse detection in frame {frame_idx}")
            dv = float(m.velocity_ms[0]) - v_true
            dr = float(m.range_m[0]) - r_true
            found.append((frame_idx, fi, round(dv, 4), round(dr, 3)))
            if abs(dv) >= 0.3 or abs(dr) >= 2 * prof.delta_r:
                fail(f"G0: frame {frame_idx} strongest long detection off the truth by "
                     f"{dv:.3f} m/s, {dr:.2f} m")
            if not first:
                first.update(idx=frame_idx, res=res, fi=fi)

        kpcr.fused_pc_rdm.launches = 0
        kcfar.cascaded_cfar2d.launches = 0
        argv = ["dmx", "--input", root, "--frames", str(len(G0_FREQ_INDEX)), "--device", "cuda"]
        t0 = time.perf_counter()
        rc = cli.main(argv, on_result=on_result)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fused_pc_rdm": kpcr.fused_pc_rdm.launches,
                    "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
        if rc != 0 or len(stamps) != len(G0_FREQ_INDEX):
            fail(f"G0: cli dmx rc {rc}, {len(stamps)} frames (want {len(G0_FREQ_INDEX)})")
        if min(launches.values()) < 1:
            fail(f"G0: a kernel did not run on the main path: {launches}")
        calls = g0_kernel_calls(zip(G0_FREQ_INDEX, G0_BEAM_POS))
        if launches != {"fused_pc_rdm": calls, "cascaded_cfar2d": calls}:
            fail(f"G0: launches {launches} for {len(stamps)} frames (want {calls} of each: "
                 "one a segment on each n_clutter's eager frame and on its capture)")
        rate = (len(stamps) - 1) / (stamps[-1] - stamps[0])
        reader_cls = g1_reader_class()   # the one the CLI picked by default
        print(f"G0: cli dmx ({reader_cls.__name__}) {len(stamps)} frames in {wall:.2f} s "
              f"(the first builds the chain's constants); frames 2-{len(stamps)} at "
              f"{rate:.2f} frames/s (real time {G0_REAL_TIME:.2f}); launches {launches}; "
              f"strongest long detection (frame, freq, dv m/s, dr m): {found}")

        # the first frame against the plain versions on the same data
        chain = G0Chain(device=dev, freq_index=first["fi"])
        reader = reader_cls(root, prt_num=prof.prt_per_frame, point_prt=prof.point_prt,
                            frames_per_file=10)
        t0 = time.perf_counter()
        frames = [reader.read_frame(i) for i in range(1, len(G0_FREQ_INDEX) + 1)]
        parse_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        left, right = frames[first["idx"] - 1][:2]
        beams = chain.beams(left, right)
        ps = prof.segment_points[0]
        nc = chain.n_clutter
        res = first["res"]
        ok = True
        for name, seg, m_re, m_im in (
                ("short", beams[..., :ps], chain.pc_short_re, chain.pc_short_im),
                ("long", beams[..., ps:], chain.pc_long_re, chain.pc_long_im)):
            a = kpcr.fused_pc_rdm_plain(seg, m_re, m_im, chain.dft_re, chain.dft_im)
            want = zero_velocity_notch_unshifted(a[0] + a[1], nc)
            got = getattr(res, f"rdm_sum_{name}")
            max_abs, _, peak = rdm_error(got, want)
            rdm_ok = bool(((got - want).abs() <= 2e-5 * peak + 2e-4 * want.abs()).all())
            pf, pv = plain_cfar(got, prof.cfar, nc)
            flags_ok = (torch.equal(pf, getattr(res, f"flags_{name}"))
                        and torch.equal(pv, getattr(res, f"vflags_{name}")))
            ok = ok and rdm_ok and flags_ok
            print(f"G0: frame {first['idx']} {name} sum RDM vs plain max_abs_err {max_abs:.3e} "
                  f"(peak {peak:.3e}) -> {'ok' if rdm_ok else 'FAIL'}; flags vs plain CFAR on "
                  f"the returned RDM -> {'bit-identical' if flags_ok else 'MISMATCH'}")
        if not ok:
            fail("G0: dmx output disagrees with the plain versions")

        params, _ = chain.frame_params(first["fi"], G0_BEAM_POS[0])
        host = [torch.from_numpy(np.asarray(x, np.complex64)).pin_memory() for x in (left, right)]
        s_abs, l_abs = chain.front(beams)
        sum_s = zero_velocity_notch_unshifted(s_abs[0] + s_abs[1], nc)
        sum_l = zero_velocity_notch_unshifted(l_abs[0] + l_abs[1], nc)
        f_s, _ = kcfar.cascaded_cfar2d(sum_s, prof.cfar, nc)
        f_l, _ = kcfar.cascaded_cfar2d(sum_l, prof.cfar, nc)
        d_s = extract_detections(f_s, sum_s, 32)
        d_l = extract_detections(f_l, sum_l, 32)
        diff_s, diff_l = s_abs[1] - s_abs[0], l_abs[1] - l_abs[0]
        kw = dict(delta_r=prof.delta_r, v_scale=params.v_scale, delta_v=params.delta_v,
                  k_value=params.k_value, beam_pos=params.beam_pos,
                  beam_angle_step=chain_cfg.beam_angle_step, n_clutter=nc)
        ms = cuda_ms({
            "h2d": lambda: torch.stack([h.to(dev, non_blocking=True) for h in host]),
            "b3_short": lambda: kpcr.fused_pc_rdm(beams[..., :ps], chain.pc_short_re,
                                                  chain.pc_short_im, chain.dft_re, chain.dft_im),
            "b3_long": lambda: kpcr.fused_pc_rdm(beams[..., ps:], chain.pc_long_re,
                                                 chain.pc_long_im, chain.dft_re, chain.dft_im),
            "b1_short": lambda: kcfar.cascaded_cfar2d(sum_s, prof.cfar, nc),
            "b1_long": lambda: kcfar.cascaded_cfar2d(sum_l, prof.cfar, nc),
            "extract": lambda: (extract_detections(f_s, sum_s, 32),
                                extract_detections(f_l, sum_l, 32)),
            "measure": lambda: (
                motion_parameters(sum_s, diff_s, d_s, r_scale=chain.r_scale_short, **kw),
                motion_parameters(sum_l, diff_l, d_l, r_scale=chain.r_scale_long, **kw)),
        }, reps=5)
        print("G0: stage median ms (CUDA events, one frame): "
              + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" | sum {sum(ms.values()):.3f} | host .bin parse {parse_ms:.1f} ms/frame "
              f"({reader_cls.__name__}, wall clock)")
        outputs = phase_dmx_outputs(dev, root, fd, r_true)
    return {"launches": launches, "frames_per_s": rate, "stage_ms": ms, "parse_ms": parse_ms,
            "outputs": outputs}


def g2_echo_batch(prof, scr: float, n_frames: int, seed: int = 0) -> np.ndarray:
    """The sweep's echoes of one SCR (``evalx.sweep.sweep_thresholds``): the
    target at TARGET_V, TARGET_R over the clutter of seed ``seed + 97 f``."""
    from radar_signal_process_tpu_torch.sim import (
        add_clutter,
        apply_scr,
        synthesize_target_echo,
        synthetic_clutter,
    )

    n = prof.prt_per_frame
    target = synthesize_target_echo(prof, TARGET_V, TARGET_R, n_pulses=n)
    out = []
    for f in range(n_frames):
        clutter = synthetic_clutter(prof, n_pulses=n, seed=seed + 97 * f)
        out.append(add_clutter(apply_scr(target, clutter, scr, prof), clutter))
    return np.stack(out).astype(np.complex64)


def b2_report(label: str, pc: torch.Tensor, w_re, w_im, notch) -> dict:
    """B2 against its plain version and the complex128 product at one
    shape; times of both (CUDA events, in turns) beside the bound."""
    from radar_signal_process_tpu_torch.kernels.rdm import doppler_rdm, doppler_rdm_plain

    got = doppler_rdm(pc, w_re, w_im, notch)
    want = doppler_rdm_plain(pc, w_re, w_im, notch)
    torch.cuda.synchronize()
    max_abs, max_rel, peak = rdm_error(got, want)
    ok = bool(((got - want).abs() <= 2e-5 * peak + RDM_RTOL * want.abs()).all())
    exact = torch.matmul(torch.complex(w_re, w_im).to(torch.complex128),
                         pc.to(torch.complex128)).abs()
    exact[..., notch[0] : notch[1] + 1, :] = 0.0
    err_c128, plain_c128 = c128_error(got, exact), c128_error(want, exact)
    del exact, want
    w_c = torch.complex(w_re, w_im)
    ms = cuda_ms({"kernel": lambda: doppler_rdm(pc, w_re, w_im, notch),
                  "plain": lambda: doppler_rdm_plain(pc, w_re, w_im, notch),
                  "library": lambda: torch.matmul(w_c, pc)})
    del w_c
    n_fft, n = w_re.shape
    c = cost_model.rdm_former_cost(pc.numel() // (n * pc.shape[-1]), n, pc.shape[-1], n_fft)
    bound, bound_by = c["sol_s"] * 1e3, c["bound_by"]
    print(f"B2 doppler_rdm [{label}] {tuple(pc.shape)} -> {tuple(got.shape)}: max_abs_err "
          f"{max_abs:.3e} max_rel_err {max_rel:.3e} (peak {peak:.3e}) vs plain (2e-5*peak + "
          f"{RDM_RTOL}*|want|) -> {'ok' if ok else 'FAIL'}; vs complex128 product: max error "
          f"/ peak kernel {err_c128:.3e} plain {plain_c128:.3e} (kernel <= {C128_PEAK}) -> "
          f"{'ok' if err_c128 <= C128_PEAK else 'FAIL'}; median ms kernel {ms['kernel']:.3f} "
          f"plain {ms['plain']:.3f} library (complex matmul) {ms['library']:.3f}; bound "
          f"{bound:.3f} ms by {bound_by} | {SMI['line']}")
    if not (ok and err_c128 <= C128_PEAK):
        fail(f"B2 [{label}]: kernel disagrees with its plain version or the complex128 product")
    return {"max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": bound, "bound_by": bound_by, "library_ms": ms["library"],
            "error_vs_c128": err_c128, "plain_error_vs_c128": plain_c128,
            "shape": list(pc.shape)}


def phase_g1(dev) -> dict:
    from radar_signal_process_tpu_torch.config import G1_PROFILE as prof
    from radar_signal_process_tpu_torch.config import G1_RANGE_CONCAT
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models.g1_chain import (
        g1_validation_chain,
        make_g1_validation_chain,
    )
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import (
        range_concatenate,
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu_torch.params import cpi_params
    from radar_signal_process_tpu_torch.sim import apply_scr, synthesize_target_echo, synthetic_clutter

    n = prof.prt_per_frame
    t0 = time.perf_counter()
    target = synthesize_target_echo(prof, TARGET_V, TARGET_R, n_pulses=n)
    echo = np.stack([apply_scr(target, c, G1_SCR_DB, prof) + c
                     for c in (synthetic_clutter(prof, seed=s) for s in (7, 8))])
    x = torch.from_numpy(echo.astype(np.complex64)).to(dev)
    print(f"G1: seeded echo 2 beams x {n} x {prof.point_prt} (target {TARGET_V} m/s at "
          f"{TARGET_R} m, {G1_SCR_DB} dB SCR) in {time.perf_counter() - t0:.1f} s")
    g1_validation_chain(x, prof)            # builds the chain's constants
    torch.cuda.synchronize()
    krdm.doppler_rdm.launches = 0
    rdm = g1_validation_chain(x, prof)
    torch.cuda.synchronize()
    launches = {"doppler_rdm": krdm.doppler_rdm.launches}
    if launches["doppler_rdm"] != 1:
        fail(f"G1: {launches['doppler_rdm']} B2 launches for one chain call (want 1)")
    if rdm.shape != (2, n, 868) or not bool(torch.isfinite(rdm).all()):
        fail(f"G1: bad RDM shape {tuple(rdm.shape)} or non-finite values")
    v_axis = prof.velocity_axis(n)
    found = []
    for b in range(2):
        vi, ri = np.unravel_index(int(rdm[b].argmax()), (n, 868))
        mid = int(rdm[b, vi, 82:318].argmax()) + 82
        found.append((float(v_axis[vi]), int(ri), mid))
        if abs(v_axis[vi] - TARGET_V) >= 0.3 or mid != 128:
            fail(f"G1: beam {b} peak at v {v_axis[vi]:.3f} m/s, mid-segment column {mid} "
                 f"(want {TARGET_V} +- 0.3, 128)")
    ms = cuda_ms({"chain": lambda: g1_validation_chain(x, prof)})["chain"]
    print(f"G1: g1_validation_chain on the card: {ms:.3f} ms per call (CUDA events); "
          f"launches {launches}; peak per beam (v m/s, column, mid-segment column) {found}")
    chain = make_g1_validation_chain(prof, device=dev)     # the same constants
    pc = range_concatenate(segmented_pulse_compression(
        x, prof, chain.pc_spectra, chain.pc_filter_lens), G1_RANGE_CONCAT)
    params = cpi_params(prof, n, x.device)
    stats = b2_report("G1", pc, params.dft_re, params.dft_im,
                      notch_rows(n, prof.mtd.notch_divisor))
    return {"launches": launches, "ms": ms, "b2": stats}


def phase_sweep(dev) -> dict:
    import dataclasses

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.evalx import evaluate_frames
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, renotch_rows
    from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import segmented_pulse_compression
    from radar_signal_process_tpu_torch.params import cpi_params

    seen: dict = {}
    krdm.doppler_rdm.launches = 0
    kcfar.cascaded_cfar2d.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["sweep", "--device", dev.type], on_result=seen.update)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    scrs = sorted({k[0] for k in SWEEP_REFERENCE})
    thresholds = sorted({k[1] for k in SWEEP_REFERENCE})
    if rc != 0 or set(seen) != set(SWEEP_REFERENCE):
        fail(f"sweep: cli sweep rc {rc}, cells {sorted(seen)}")
    if launches != {"doppler_rdm": len(scrs), "cascaded_cfar2d": len(scrs) * len(thresholds)}:
        fail(f"sweep: launches {launches} (want B2 once per SCR, B1 once per threshold per SCR)")
    bad = []
    for key, (pd, fa, acc, pcf) in SWEEP_REFERENCE.items():
        m = seen[key]
        if ((m["detection_rate"], m["accuracy"], m["localization_pcf"]) != (pd, acc, pcf)
                or abs(m["false_alarm_rate"] - fa) > SWEEP_FA_TOL):
            bad.append((key, m))
    print(f"sweep: cli sweep G2 full width ({len(scrs)} SCRs x {len(thresholds)} thresholds x "
          f"4 frames of {prof.prt_per_frame} x {prof.point_prt}) in {wall:.2f} s wall; launches {launches}; table vs the "
          f"reference (Pd, acc, PCF equal, FA rate +- {SWEEP_FA_TOL}) -> "
          f"{'ok' if not bad else 'FAIL'}; FA rates "
          + " ".join(f"{k[0]:g}/{k[1]:g}:{seen[k]['false_alarm_rate']:.4e}" for k in sorted(seen)))
    if bad:
        fail(f"sweep: cells off the reference table: {bad}")

    # every threshold's B1 flags (the re-notch fused, as the sweep runs
    # it) against the plain version on the same RDMs
    n_clutter = clutter_cells(prof, prof.prt_per_frame)
    zero = renotch_rows(prof, prof.prt_per_frame, n_clutter, 20)
    r_axis, v_axis = prof.range_axis(prof.point_prt), prof.velocity_axis(prof.prt_per_frame)
    r_true = r_axis[prof.segment_starts[1] + round(TARGET_R / prof.delta_r)]
    max_abs, mismatched = 0.0, 0
    for scr in scrs:
        x = torch.from_numpy(g2_echo_batch(prof, scr, 4)).to(dev)
        rdm = mtd_produce(x, prof)
        for t in thresholds:
            cfg = dataclasses.replace(prof.cfar, threshold=t)
            kf, kv = kcfar.cascaded_cfar2d(rdm, cfg, n_clutter, prof.cfar_segments,
                                           zero_rows=zero)
            pf, pv = kcfar.cascaded_cfar2d_plain(rdm, cfg, n_clutter, prof.cfar_segments, zero)
            diff = torch.cat([(kf != pf).flatten(), (kv != pv).flatten()])
            mismatched += int(diff.sum())
            max_abs = max(max_abs, float(diff.float().max()))
            m = evaluate_frames(list(pf.cpu().numpy()), list(rdm.cpu().numpy()), [r_true] * 4,
                                [TARGET_V] * 4, r_axis, v_axis)
            if json.dumps(m) != json.dumps(seen[(scr, t)]):     # NaN equals NaN
                fail(f"sweep: the plain version's metrics at {(scr, t)} differ: {m}")
    print(f"sweep: B1 flags vs plain on the same RDMs at every (SCR, T): {mismatched} differ "
          f"-> {'bit-identical' if mismatched == 0 else 'MISMATCH'}; the plain flags give the "
          f"same table")
    if mismatched:
        fail(f"sweep: {mismatched} B1 flags differ from the plain version")
    cfg = dataclasses.replace(prof.cfar, threshold=thresholds[0])
    b1 = b1_report("sweep, 4 frames, re-notch fused", rdm, cfg, n_clutter,
                   lambda: kcfar.cascaded_cfar2d(rdm, cfg, n_clutter, prof.cfar_segments,
                                                 zero_rows=zero),
                   lambda: kcfar.cascaded_cfar2d_plain(rdm, cfg, n_clutter, prof.cfar_segments,
                                                       zero),
                   notched_rows=zero[1] - zero[0])
    b1.update(max_abs_err=max_abs, mismatched_flags=mismatched, library_ms=None)
    params = cpi_params(prof, prof.prt_per_frame, x.device)
    pc = segmented_pulse_compression(x, prof, params.pc_spectra, params.pc_filter_lens)
    b2 = b2_report("sweep, 4 frames", pc, params.dft_re, params.dft_im,
                   notch_rows(prof.prt_per_frame, prof.mtd.notch_divisor))
    return {"launches": launches, "wall_s": wall, "b1": b1, "b2": b2}


def phase_e2e(dev) -> dict:
    import contextlib
    import io

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm

    d = round(TARGET_R / prof.delta_r)
    cols = (prof.segment_starts[1] + d, prof.segment_starts[2] + d)    # 281, 1004
    with tempfile.TemporaryDirectory() as root:
        cap = os.path.join(root, "cap")
        t0 = time.perf_counter()
        rc = cli.main(["simulate", "--output", cap, "--frames", "3", "--velocity",
                       str(TARGET_V), "--range", str(TARGET_R)])
        sim_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"e2e: cli simulate rc {rc}")
        windows: list = []

        def on_result(frame, rdms, flags, dets, seconds):
            if not bool(torch.isfinite(rdms).all()):
                fail(f"e2e: non-finite RDM in window {frame}")
            windows.append((frame, seconds, tuple(rdms.shape)))

        out = []
        krdm.doppler_rdm.launches = 0
        kcfar.cascaded_cfar2d.launches = 0
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["e2e", "--input", cap, "--frames", "2", "--device", dev.type],
                          on_result=on_result)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                    "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
        frames = json.loads(buf.getvalue())["frames"]
        if rc != 0 or [f["frame"] for f in frames] != [0, 1] or len(windows) != 2:
            fail(f"e2e: cli e2e rc {rc}, frames {[f['frame'] for f in frames]}")
        if launches != {"doppler_rdm": 2, "cascaded_cfar2d": 2}:
            fail(f"e2e: launches {launches} (want B2 and B1 once per window)")
        for f in frames:
            hits = [r for r in f["detections"] if min(abs(r[3] - c) for c in cols) <= 1]
            out.append((f["frame"], len(f["detections"]), len(hits)))
            if not hits:
                fail(f"e2e: target not detected at column {cols[0]} or {cols[1]} (+-1) in "
                     f"window {f['frame']}")
        ms = [w[1] * 1e3 for w in windows]
        print(f"e2e: cli simulate 3 frames G2 ({prof.n_channels} ch) in {sim_s:.1f} s; cli e2e "
              f"{len(windows)} windows of {windows[0][2]} in {wall:.2f} s; mtd+cfar ms per window "
              f"(StageTimers, synchronized) {[round(x, 3) for x in ms]}; launches {launches}; "
              f"(window, rows, rows at column {cols[0]}/{cols[1]}) {out}")
        mesh = phase_e2e_mesh(dev, cap, frames)
        stages = phase_stages(dev, root, frames, cols)
    return {"launches": launches, "ms_per_window": ms, "stages": stages, "mesh": mesh}


def phase_e2e_mesh(dev, cap: str, e2e_frames: list, win_slice: int = 1) -> dict:
    """``cli e2e --mesh 1x1 --win-slice 1`` over the e2e capture: an NCCL
    group of one, B2 and B1 once per window, and the rows of ``cli e2e``
    for that slice and the profile's 13 beams of the 16 channel rows (as
    the JAX ``e2e --mesh`` reports them, ROADMAP C11), bit for bit."""
    import contextlib
    import io

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm

    buf = io.StringIO()
    windows: list = []
    krdm.doppler_rdm.launches = 0
    kcfar.cascaded_cfar2d.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["e2e", "--input", cap, "--frames", "2", "--device", dev.type, "--mesh", "1x1",
                       "--win-slice", str(win_slice)],
                      on_result=lambda frame, rdm, flags, dets, s: windows.append((frame, s)))
    torch.cuda.synchronize()
    launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    got = json.loads(buf.getvalue())["frames"]
    want = [{"frame": f["frame"], "detections": [r for r in f["detections"]
                                                 if r[1] == win_slice and r[0] < prof.n_beams]}
            for f in e2e_frames]
    same = ([f["frame"] for f in got] == [f["frame"] for f in want]
            and all(sorted(g["detections"]) == sorted(w["detections"]) for g, w in zip(got, want)))
    print(f"mesh: cli e2e --mesh 1x1 --win-slice {win_slice}: rc {rc}, launches {launches}; "
          f"rows vs cli e2e's of slice {win_slice}, rows 0-{prof.n_beams - 1} "
          f"({sum(len(w['detections']) for w in want)} rows) "
          f"-> {'bit-identical' if same else 'MISMATCH'}; mtd+cfar ms per window "
          f"{[round(s * 1e3, 3) for _, s in windows]}")
    if rc != 0 or launches != {"doppler_rdm": 2, "cascaded_cfar2d": 2}:
        fail(f"mesh: cli e2e --mesh 1x1 rc {rc}, launches {launches} (want 2 of each)")
    if not same:
        fail("mesh: cli e2e --mesh 1x1 rows differ from cli e2e's")
    return {"launches": launches, "ms_per_window": [s * 1e3 for _, s in windows]}


def drive_stage(label: str, argv: list) -> tuple[dict, list]:
    """One stage CLI run with the launch counters set to 0 just before it and
    read just after: (launches, [(frame, {stage: wall s})] of every frame it
    wrote)."""
    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm

    records: list = []
    krdm.doppler_rdm.launches = 0
    kcfar.cascaded_cfar2d.launches = 0
    rc = cli.main(argv, on_result=lambda idx, out, secs: records.append((idx, secs)))
    torch.cuda.synchronize()
    launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    if rc != 0:
        fail(f"stages: cli {label} rc {rc}")
    return launches, records


def per_frame(records: list) -> str:
    """Mean wall seconds per frame of each stage of ``records``."""
    names = records[0][1]
    return " ".join(f"{k} {np.mean([r[1][k] for r in records]):.3f}" for k in names)


def phase_stages(dev, root: str, e2e_frames: list, cols: tuple) -> dict:
    """The e2e phase's capture through the stage CLIs and their file bus:
    ``ingest`` -> ``mtd`` (B2 once per frame pair) -> ``detect`` (B1 once
    per frame) in the npz form, equal to ``cli e2e``'s detections bit for
    bit; one frame pair in the mat form, equal to the npz bus; ``ingest
    --dbf-coeffs`` against a complex128 product; ``detect --thresholds``
    (B1 once per threshold per frame), its T=5 files equal to ``--threshold
    5``'s; the RDMs and flags that were written against the plain versions."""
    import dataclasses

    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, renotch_mask
    from radar_signal_process_tpu_torch.models.mtd_pipeline import slice_cpi_window
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import segmented_pulse_compression
    from radar_signal_process_tpu_torch.params import chain_params
    from radar_signal_process_tpu_torch.utils import load_frame, matbus

    cap = os.path.join(root, "cap")
    d = {k: os.path.join(root, k) for k in ("frames", "rdm", "det", "sweep", "frames_mat",
                                             "rdm_mat", "det_mat", "frames_dbf")}
    on_card = ["--device", dev.type]
    launches, seconds = {}, {}

    def run(label, argv, n_frames, b2, b1):
        launches[label], seconds[label] = drive_stage(label, argv)
        want = {"doppler_rdm": b2, "cascaded_cfar2d": b1}
        if launches[label] != want or len(seconds[label]) != n_frames:
            fail(f"stages: cli {label} launches {launches[label]} (want {want}), "
                 f"{len(seconds[label])} frames written (want {n_frames})")

    # the npz bus over both frame pairs, at e2e's detection capacity (16)
    t0 = time.perf_counter()
    run("ingest", ["ingest", "--input", cap, "--output", d["frames"], "--frames", "3"], 3, 0, 0)
    run("mtd", ["mtd", "--input", d["frames"], "--output", d["rdm"], "--frames", "2"] + on_card,
        2, 2, 0)
    run("detect", ["detect", "--input", d["rdm"], "--output", d["det"], "--frames", "2",
                   "--max-detections", "16"] + on_card, 2, 0, 2)
    wall = time.perf_counter() - t0
    for f, window in enumerate(e2e_frames):
        a = load_frame(d["det"], f)[0]
        rows = [[b, w, int(v), int(r), float(x)] for b, w in np.ndindex(*a["det_valid"].shape[:2])
                for v, r, x in zip(a["det_v"][b, w][a["det_valid"][b, w]],
                                   a["det_r"][b, w][a["det_valid"][b, w]],
                                   a["det_amp"][b, w][a["det_valid"][b, w]])]
        if rows != window["detections"]:
            fail(f"stages: frame {f} detections of the file bus differ from cli e2e's")
        if not any(min(abs(r[3] - c) for c in cols) <= 1 for r in rows):
            fail(f"stages: target not at column {cols[0]} or {cols[1]} in window {f}")
    print(f"stages: cli ingest -> mtd -> detect (npz, 3 frames of {prof.n_channels} ch x "
          f"{prof.prt_per_frame} x {prof.point_prt}, "
          f"2 frame pairs) in {wall:.1f} s; launches ingest {launches['ingest']} mtd "
          f"{launches['mtd']} detect {launches['detect']}; detections of every (channel, slice) "
          f"of both pairs equal cli e2e's bit for bit ({sum(len(w['detections']) for w in e2e_frames)}"
          f" rows), target at column {cols[0]}/{cols[1]} in both")

    # one frame pair through the mat bus: the same numbers as the npz bus
    run("ingest mat", ["ingest", "--input", cap, "--output", d["frames_mat"], "--frames", "2",
                       "--format", "mat"], 2, 0, 0)
    run("mtd mat", ["mtd", "--input", d["frames_mat"], "--output", d["rdm_mat"], "--frames", "1",
                    "--format", "mat"] + on_card, 1, 1, 0)
    run("detect mat", ["detect", "--input", d["rdm_mat"], "--output", d["det_mat"], "--frames",
                       "1", "--format", "mat"] + on_card, 1, 0, 1)
    npz = [load_frame(d[k], 0)[0] for k in ("frames", "rdm", "det")]
    iq, _ = matbus.load_frame_mat(matbus.mat_frame_path(d["frames_mat"], 0))
    rdm = matbus.load_mtd_mat(matbus.mat_frame_path(d["rdm_mat"], 0))
    flags = matbus.load_cfar_mat(matbus.mat_frame_path(d["det_mat"], 0))
    mat_ok = (np.array_equal(iq, npz[0]["iq"]) and np.array_equal(rdm, npz[1]["rdm"])
              and np.array_equal(flags, npz[2]["flags"]))
    print(f"stages: mat bus (sig_data_DBF_allprts -> MTD_win_all_beams -> cfarFlag_win_*) for "
          f"frame pair 0: stage 1, RDMs and flags vs the npz bus -> "
          f"{'bit-identical' if mat_ok else 'MISMATCH'}")
    if not mat_ok:
        fail("stages: the mat bus differs from the npz bus")

    # DBF on the card against a complex128 product of the stage-1 channels
    rng = np.random.default_rng(SEED + 6)
    coeffs = rng.standard_normal((13, 16)) + 1j * rng.standard_normal((13, 16))
    coeff_path = os.path.join(root, "dbf_stage.txt")
    inter = np.empty((13, 32))
    inter[:, 0::2], inter[:, 1::2] = coeffs.real, coeffs.imag
    np.savetxt(coeff_path, inter)
    run("ingest dbf", ["ingest", "--input", cap, "--output", d["frames_dbf"], "--frames", "1",
                       "--dbf-coeffs", coeff_path] + on_card, 1, 0, 0)
    beams = load_frame(d["frames_dbf"], 0)[0]["iq"]
    c64 = np.loadtxt(coeff_path)
    c64 = (c64[:, 0::2] + 1j * c64[:, 1::2]).astype(np.complex64).astype(np.complex128)
    exact = (npz[0]["iq"].reshape(-1, 16).astype(np.complex128) @ c64.T).reshape(beams.shape)
    dbf_err = float(np.abs(beams - exact).max() / np.abs(exact).max())
    print(f"stages: ingest --dbf-coeffs (13 x 16, seeded) on the card: {beams.shape} "
          f"{beams.dtype}, max error / peak vs complex128 product {dbf_err:.3e} (<= 1e-5) -> "
          f"{'ok' if dbf_err <= 1e-5 and beams.dtype == np.complex64 else 'FAIL'}")
    if dbf_err > 1e-5 or beams.dtype != np.complex64:
        fail("stages: DBF beams off the complex128 product")

    # the threshold sweep: B1 once per threshold per frame
    thresholds = ("3", "5", "7")
    run("detect sweep", ["detect", "--input", d["rdm"], "--output", d["sweep"], "--frames", "2",
                         "--max-detections", "16", "--thresholds", *thresholds] + on_card,
        2, 0, 2 * len(thresholds))
    same = all(
        all(np.array_equal(v, load_frame(d["det"], f)[0][k]) for k, v in
            load_frame(f"{d['sweep']}_T5", f)[0].items()) for f in range(2))
    dirs = sorted(p for p in os.listdir(root) if p.startswith("sweep_T"))
    print(f"stages: detect --thresholds {' '.join(thresholds)}: dirs {dirs}, launches "
          f"{launches['detect sweep']}; T=5 files vs --threshold 5 -> "
          f"{'bit-identical' if same else 'MISMATCH'}")
    if not same or dirs != [f"sweep_T{t}" for t in thresholds]:
        fail("stages: the sweep's T=5 output differs from the single-threshold run")

    # what mtd and detect wrote, against the plain versions on the card
    params = chain_params(prof, device=dev)
    notch = notch_rows(prof.prt_per_frame, prof.mtd.notch_divisor)
    n_clutter = clutter_cells(prof, prof.prt_per_frame)
    keep = torch.from_numpy(renotch_mask(prof, prof.prt_per_frame, n_clutter, 20)).to(dev)
    b2_err, b1_diff = 0.0, 0
    for f in range(2):
        a, b = (torch.from_numpy(load_frame(d["frames"], i)[0]["iq"]).to(dev)
                .permute(2, 0, 1).contiguous() for i in (f, f + 1))
        pc = slice_cpi_window(segmented_pulse_compression(
            torch.cat([a, b], dim=-2), prof, params.pc_spectra, params.pc_filter_lens), 4)
        want = krdm.doppler_rdm_plain(pc, params.dft_re, params.dft_im, notch)
        got = torch.from_numpy(load_frame(d["rdm"], f)[0]["rdm"]).to(dev)
        peak = float(want.abs().max())
        if not bool(((got - want).abs() <= 2e-5 * peak + RDM_RTOL * want.abs()).all()):
            fail(f"stages: frame {f} RDM of cli mtd off the plain version")
        b2_err = max(b2_err, float((got - want).abs().max()))
        del pc, want
        written = load_frame(d["det"], f)[0]
        for t in thresholds:
            cfg = dataclasses.replace(prof.cfar, threshold=float(t))
            pf, pv = segmented_cfar(got * keep[:, None], prof.cfar_segments, cfg, n_clutter)
            sw = load_frame(f"{d['sweep']}_T{t}", f)[0]
            b1_diff += int((pf.cpu().numpy() != sw["flags"]).sum()
                           + (pv.cpu().numpy() != sw["vflags"]).sum())
            if t == "5":
                b1_diff += int((pf.cpu().numpy() != written["flags"]).sum())
    print(f"stages: RDMs cli mtd wrote vs B2's plain version on the card: max_abs_err "
          f"{b2_err:.3e} (2e-5*peak + {RDM_RTOL}*|want|) -> ok; flags cli detect wrote vs the "
          f"plain CFAR on those RDMs at T {'/'.join(thresholds)}: {b1_diff} differ -> "
          f"{'bit-identical' if b1_diff == 0 else 'MISMATCH'}")
    if b1_diff:
        fail(f"stages: {b1_diff} flags written by cli detect differ from the plain CFAR")
    print("stages: wall seconds per frame (device stages end in a synchronize; load/save are "
          "npz or mat file I/O): " + " | ".join(
              f"{k}: {per_frame(v)}" for k, v in seconds.items()) + f" | {SMI['line']}")
    return {"launches": launches, "seconds": seconds, "b2_max_abs_err": b2_err,
            "b1_mismatched_flags": b1_diff, "dbf_error_vs_c128": dbf_err}


def phase_dmx_outputs(dev, root: str, fd: float, r_true: float) -> dict:
    """``cli dmx --gps --save-results`` (and ``--plots`` where matplotlib is
    installed) over the G0 phase's capture, with a GPS track of the truth
    written beside it: residuals present and finite, the result struct
    loads with the chain's config echo."""
    import contextlib
    import dataclasses
    import io
    import pkgutil

    import scipy.io as sio

    from radar_signal_process_tpu_torch import cli
    from radar_signal_process_tpu_torch.config import G0_PROFILE as prof
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
    from radar_signal_process_tpu_torch.models.g0_chain import C_LIGHT
    from radar_signal_process_tpu_torch.ops.tables import freq_value

    has_mpl = any(m.name == "matplotlib" for m in pkgutil.iter_modules())
    print(f"dmx outputs: matplotlib {'is' if has_mpl else 'is not'} installed here; "
          f"--plots {'is' if has_mpl else 'is not'} driven")
    n = len(G0_FREQ_INDEX)
    t_frame = prof.prt * prof.prt_per_frame
    gps = os.path.join(root, "gps.txt")
    with open(gps, "w") as fh:        # frame i (1-based) at time i * t_frame
        for i in range(n + 1):
            v = -(C_LIGHT / freq_value(G0_FREQ_INDEX[max(i, 1) - 1])) * fd / 2.0
            fh.write(f"{i * t_frame:.6f} {r_true:.3f} {v:.4f} 100.0 50.0\n")
    argv = ["dmx", "--input", root, "--frames", str(n), "--device", dev.type, "--gps", gps,
            "--save-results", os.path.join(root, "results")]
    if has_mpl:
        argv += ["--plots", os.path.join(root, "plots")]
    buf = io.StringIO()
    kpcr.fused_pc_rdm.launches = 0
    kcfar.cascaded_cfar2d.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = {"fused_pc_rdm": kpcr.fused_pc_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    out = json.loads(buf.getvalue())
    calls = g0_kernel_calls(zip(G0_FREQ_INDEX, G0_BEAM_POS))
    if rc != 0 or launches != {"fused_pc_rdm": calls, "cascaded_cfar2d": calls}:
        fail(f"dmx outputs: cli dmx rc {rc}, launches {launches} (want {calls} of each)")
    n_long = sum(len(f["long"]["range_m"]) for f in out["frames"])
    res = {k: out.get(f"gps_{k}_residuals") for k in ("range", "velocity")}
    for k, r in res.items():
        if not r or r["n"] != n_long or not all(np.isfinite([r["rmse"], r["bias"], r["max_abs"]])):
            fail(f"dmx outputs: gps_{k}_residuals {r} (want {n_long} finite residuals)")
    m = sio.loadmat(out["result_mat"], squeeze_me=True)
    echo = [f.name for f in dataclasses.fields(G0ChainConfig)]
    missing = [k for k in echo + ["resultEst_Struct", "freqIndSeries", "angleCodeSeries"]
               if k not in m]
    if missing or list(np.atleast_1d(m["freqIndSeries"])) != list(G0_FREQ_INDEX):
        fail(f"dmx outputs: {os.path.basename(out['result_mat'])} lacks {missing} or has "
             f"freqIndSeries {m.get('freqIndSeries')}")
    plots = sorted(os.path.basename(p) for p in out.get("plots", {}).values())
    if has_mpl and plots != ["estimates_long.png", "estimates_short.png"]:
        fail(f"dmx outputs: plots {plots}")
    print(f"dmx outputs: cli dmx --gps --save-results{' --plots' if has_mpl else ''} over the "
          f"{n}-frame G0 capture: launches {launches}; range residuals {res['range']}; velocity "
          f"residuals {res['velocity']}; {os.path.basename(out['result_mat'])} with "
          f"{len(echo)} config fields; plots {plots}")
    return {"launches": launches, "residuals": res, "plots": plots}


def phase_bench(dev) -> dict:
    """The port's bench at a short length on the card (phase 16): it prints
    its JSON line; every check must pass and each kernel must have run in
    the workloads that drive it."""
    from radar_signal_process_tpu_torch import bench
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
    from radar_signal_process_tpu_torch.kernels import rdm as krdm

    krdm.doppler_rdm.launches = kcfar.cascaded_cfar2d.launches = kpcr.fused_pc_rdm.launches = 0
    t0 = time.perf_counter()
    result = bench.run(dev, repeat=3, stream_frames=7, skip_oracle=True)
    wall = time.perf_counter() - t0
    counts = result["launches"]
    if not result["ok"]:
        fail(f"bench: checks failed: {[k for k, v in result['checks'].items() if not v['ok']]}")
    want = {"doppler_rdm": ("headline", "block", "stages", "e2e_stream", "e2e_stream_block"),
            "cascaded_cfar2d": ("headline", "block", "stages", "g0", "e2e_stream",
                                "e2e_stream_block"),
            "fused_pc_rdm": ("g0",)}
    idle = [(k, w) for k, ws in want.items() for w in ws if counts[w][k] < 1]
    if idle:
        fail(f"bench: a kernel did not run in a workload that drives it: {idle}")
    flags = result["checks"]["headline_b1"]["flags"]
    if flags != HEADLINE_FLAGS:
        fail(f"bench: B1 raised {flags} flags on the headline window, not {HEADLINE_FLAGS}")
    print(f"bench: all workloads in {wall:.1f} s, every check ok; headline "
          f"{result['value']:.2f} frames/s (p50 {result['frame_ms_p50']:.3f} ms, "
          f"{result['timing_samples']} calls), block {result['block_window_ms_p50']:.3f} ms a "
          f"window, e2e stream {result['e2e_stream_frames_per_s']:.2f} windows/s; launches "
          f"{counts} | {SMI['line']}")
    return result


def hold_dryrun_legs(legs: dict, dev) -> dict:
    """The world-1 dry run's legs at their own shapes (2 beams x 8 pulses x
    3404 cells; n_clutter 2 and the divisor-20 re-notch leave 3 rows, below
    the CFAR parity floor), held to the plain versions on the same inputs,
    redrawn from ``default_rng(0)`` in the dry run's order: each RDM to B2's
    plain version within the RDM tolerance, each flag plane bit for bit to
    B1's plain version run on that RDM after the re-notch."""
    import dataclasses

    from radar_signal_process_tpu_torch.config import CFARConfig, G2_PROFILE
    from radar_signal_process_tpu_torch.kernels.rdm import doppler_rdm_plain
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, renotch_mask
    from radar_signal_process_tpu_torch.models.mtd_pipeline import slice_cpi_window
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu_torch.params import cpi_params

    shape = (2, 8, G2_PROFILE.point_prt)    # (2 dp, 8 sp, cells) at dp = sp = 1
    prof = dataclasses.replace(G2_PROFILE, prt_per_frame=shape[1], n_beams=shape[0])
    rng = np.random.default_rng(0)

    def draw():
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.from_numpy(x.astype(np.complex64)).to(dev)

    echo = draw()
    frames = [draw() for _ in range(3)]
    cubes = [draw() for _ in range(5)]      # the StreamingPipeline's frames, (beams, prt, cells)
    params = cpi_params(prof, shape[1], dev)
    notch = notch_rows(prof.mtd.fft_length or shape[1], prof.mtd.notch_divisor)

    def plain_rdm(x, window: bool):
        pc = segmented_pulse_compression(x, prof, params.pc_spectra, params.pc_filter_lens)
        if window:
            pc = slice_cpi_window(pc, 4)
        return doppler_rdm_plain(pc, params.dft_re, params.dft_im, notch)

    def plain_flags(rdm, cfg, n_clutter):
        keep = torch.as_tensor(renotch_mask(prof, shape[1], n_clutter, 20), device=dev)
        return segmented_cfar(rdm * keep[:, None], prof.cfar_segments, cfg, n_clutter)[0]

    cfg5 = CFARConfig(threshold=5.0)
    n_clutter = clutter_cells(prof, shape[1], 1e-6)
    held = [("pipeline_rdm", "pipeline_flags", echo, False, cfg5, 2),
            ("stream_rdm0", "stream_flags0", torch.cat(frames[:2], -2), True, cfg5, 2),
            ("stream_rdm1", "stream_flags1", torch.cat(frames[1:], -2), True, cfg5, 2),
            ("stream_rdm1_fresh", None, torch.cat(frames[1:], -2), True, None, None)]
    held += [(f"streaming_rdm{w}", f"streaming_flags{w}", torch.cat(cubes[w:w + 2], -2), True,
              prof.cfar, n_clutter) for w in range(4)]
    worst, failed = 0.0, []
    with torch.inference_mode():
        for rdm_key, flags_key, x, window, cfg, n_c in held:
            got, want = legs[rdm_key], plain_rdm(x, window)
            if got.shape != want.shape:
                failed.append(f"{rdm_key} {tuple(got.shape)} != {tuple(want.shape)}")
                continue
            worst = max(worst, rdm_error(got, want)[0])
            if not bool(((got - want).abs() <= RDM_ATOL + RDM_RTOL * want.abs()).all()):
                failed.append(f"{rdm_key} vs B2 plain")
            if flags_key is not None:
                differ = int((legs[flags_key].bool() != plain_flags(got, cfg, n_c)).sum())
                if differ:
                    failed.append(f"{flags_key}: {differ} flags differ from B1 plain")
    return {"legs": len(held), "b2_max_abs_err": worst, "failed": failed}


def phase_entry(dev, headline_ms: float) -> dict:
    """Phase 17: ``entry()`` at full G2 width, held to the plain versions,
    timed beside the bench headline; then the world-1 dry run."""
    import contextlib
    import io

    from radar_signal_process_tpu_torch import entry
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.models.detect import renotch_mask
    from radar_signal_process_tpu_torch.models.mtd_pipeline import slice_cpi_window
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.ops.mtd import notch_rows
    from radar_signal_process_tpu_torch.ops.pulse_compression import (
        segmented_pulse_compression,
    )
    from radar_signal_process_tpu_torch.params import cpi_params

    forward, (x,) = entry.entry(dev)
    prof, n_clutter, cfg = forward.profile, forward.n_clutter, forward.cfg
    krdm.doppler_rdm.launches = kcfar.cascaded_cfar2d.launches = 0
    with torch.inference_mode():
        rdms, flags = forward(x)
    torch.cuda.synchronize()
    launches = {"doppler_rdm": krdm.doppler_rdm.launches,
                "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}
    want_shape = (prof.n_beams, 4, prof.prt_per_frame, prof.point_prt)
    if tuple(rdms.shape) != want_shape or flags.shape != rdms.shape:
        fail(f"entry: outputs {tuple(rdms.shape)} / {tuple(flags.shape)}, want {want_shape}")
    if not torch.isfinite(rdms).all():
        fail("entry: non-finite RDMs")
    if launches != {"doppler_rdm": 1, "cascaded_cfar2d": 1}:
        fail(f"entry: launches {launches} (want one B2 and one B1)")
    with torch.inference_mode():
        params = cpi_params(prof, prof.prt_per_frame, x.device)
        pc = segmented_pulse_compression(slice_cpi_window(x, 4), prof, params.pc_spectra,
                                         params.pc_filter_lens)
        notch = notch_rows(prof.prt_per_frame, prof.mtd.notch_divisor)
        same_input = torch.equal(krdm.doppler_rdm(pc, params.dft_re, params.dft_im, notch), rdms)
        plain = krdm.doppler_rdm_plain(pc, params.dft_re, params.dft_im, notch)
        del pc
        max_abs, max_rel, peak = rdm_error(rdms, plain)
        rdm_ok = bool(((rdms - plain).abs() <= RDM_ATOL + RDM_RTOL * plain.abs()).all())
        del plain
        keep = torch.as_tensor(renotch_mask(prof, prof.prt_per_frame, n_clutter, 20),
                               device=x.device)
        plain_flags, _ = segmented_cfar(rdms * keep[:, None], prof.cfar_segments, cfg, n_clutter)
        differ = int((flags.bool() != plain_flags).sum())
        del plain_flags
        ms = cuda_ms({"entry": lambda: forward(x)})["entry"]
    print(f"entry: forward step on the {tuple(x.shape)} complex64 example -> rdms "
          f"{tuple(rdms.shape)}, {int(flags.sum())} flags; launches {launches}; B2 vs plain "
          f"max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} at peak {peak:.1f} (rtol "
          f"{RDM_RTOL}, atol {RDM_ATOL}) -> {'ok' if rdm_ok else 'FAIL'}, B2 on the recomputed "
          f"slices {'bit-identical' if same_input else 'DIFFERS'}; B1 vs plain {differ} flags "
          f"differ; {ms:.3f} ms per call (median of {REPS}, CUDA events) beside the bench "
          f"headline's {headline_ms:.3f} ms | {SMI['line']}")
    if not (rdm_ok and same_input):
        fail("entry: B2 disagrees with its plain version on the step's inputs")
    if differ:
        fail(f"entry: B1 flags differ from its plain version in {differ} cells")
    x_dev = x.device
    del rdms, flags, x

    krdm.doppler_rdm.launches = kcfar.cascaded_cfar2d.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        legs = entry.dryrun_multichip(1, "cuda")
    torch.cuda.synchronize()
    check = entry.dryrun_multichip.check_launches
    dry = {"doppler_rdm": krdm.doppler_rdm.launches - check["doppler_rdm"],
           "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches - check["cascaded_cfar2d"]}
    for line in buf.getvalue().splitlines():
        print(f"entry: {line}")
    if min(dry.values()) < 1:
        fail(f"entry: the world-1 dry run's legs left a kernel idle: launches {dry}")
    bad = [k for k, v in legs.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        fail(f"entry: dry run outputs non-finite: {bad}")
    held = hold_dryrun_legs(legs, x_dev)
    print(f"entry: dryrun_multichip(1) in an NCCL group of one: legs' launches {dry}, its "
          f"checks' {check}; {held['legs']} leg RDMs vs B2 plain max_abs_err "
          f"{held['b2_max_abs_err']:.3e} (rtol {RDM_RTOL}, atol {RDM_ATOL}), their flags vs "
          f"B1 plain -> {'ok' if not held['failed'] else held['failed']} | {SMI['line']}")
    if held["failed"]:
        fail(f"entry: dry run legs disagree with the plain versions: {held['failed']}")
    return {"launches": launches, "dryrun_launches": dry, "dryrun_check_launches": check,
            "ms": ms, "headline_ms": headline_ms,
            "b2_max_abs_err": max(max_abs, held["b2_max_abs_err"]), "b1_flags_differ": differ}


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda:0")
    from radar_signal_process_tpu_torch.device import resolve_device

    resolve_device(dev)
    phase_build()
    rdm_stats, rdm_out = phase_rdm(dev)
    cfar_stats = phase_cfar(dev, rdm_out)
    del rdm_out
    launches, mesh, block = phase_slice(dev)
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    chain = G0Chain(device=dev)
    b3_stats, b3_out = phase_pc_rdm(dev, chain)
    cfar_g0_stats = phase_cfar_g0(dev, chain, b3_out)
    del b3_out, chain
    g0 = phase_g0_slice(dev)
    g1 = phase_g1(dev)
    sweep = phase_sweep(dev)
    e2e = phase_e2e(dev)
    stages = e2e["stages"]
    bench = phase_bench(dev)
    bench_launches = bench["launches"]
    ent = phase_entry(dev, bench["frame_ms_p50"])
    b1_launches = {"stream": launches["cascaded_cfar2d"],
                   "stream --mesh": mesh["launches"]["cascaded_cfar2d"],
                   "e2e --mesh": e2e["mesh"]["launches"]["cascaded_cfar2d"],
                   "dmx": g0["launches"]["cascaded_cfar2d"],
                   "sweep": sweep["launches"]["cascaded_cfar2d"],
                   "e2e": e2e["launches"]["cascaded_cfar2d"],
                   "dmx outputs": g0["outputs"]["launches"]["cascaded_cfar2d"],
                   **{k: v["cascaded_cfar2d"] for k, v in stages["launches"].items()
                      if v["cascaded_cfar2d"]},
                   **{k: v["cascaded_cfar2d"] for k, v in block["launches"].items()
                      if v["cascaded_cfar2d"]},
                   **{f"bench {k}": v["cascaded_cfar2d"] for k, v in bench_launches.items()
                      if v["cascaded_cfar2d"]},
                   "entry": ent["launches"]["cascaded_cfar2d"],
                   "dryrun_multichip(1)": ent["dryrun_launches"]["cascaded_cfar2d"],
                   "dryrun_multichip(1) checks": ent["dryrun_check_launches"]["cascaded_cfar2d"]}
    b2_launches = {"stream": launches["doppler_rdm"],
                   "stream --mesh": mesh["launches"]["doppler_rdm"],
                   "e2e --mesh": e2e["mesh"]["launches"]["doppler_rdm"],
                   "g1": g1["launches"]["doppler_rdm"],
                   "sweep": sweep["launches"]["doppler_rdm"],
                   "e2e": e2e["launches"]["doppler_rdm"],
                   **{k: v["doppler_rdm"] for k, v in stages["launches"].items()
                      if v["doppler_rdm"]},
                   **{k: v["doppler_rdm"] for k, v in block["launches"].items()
                      if v["doppler_rdm"]},
                   **{f"bench {k}": v["doppler_rdm"] for k, v in bench_launches.items()
                      if v["doppler_rdm"]},
                   "entry": ent["launches"]["doppler_rdm"],
                   "dryrun_multichip(1)": ent["dryrun_launches"]["doppler_rdm"],
                   "dryrun_multichip(1) checks": ent["dryrun_check_launches"]["doppler_rdm"]}
    kernels = [
        {"name": "doppler_rdm", "route": "cuda",
         "source": "radar_signal_process_tpu_torch/kernels/csrc/rdm.cu",
         "replaces": "radar_signal_process_tpu/kernels/rdm_pallas.py:114",
         "launches": sum(b2_launches.values()), "launches_by_path": b2_launches,
         **rdm_stats, "max_abs_err": max(rdm_stats["max_abs_err"], g1["b2"]["max_abs_err"],
                                         block["b2_block_max_abs_err"], ent["b2_max_abs_err"]),
         "entry": {k: ent[k] for k in ("ms", "headline_ms", "b2_max_abs_err")},
         "g1": g1["b2"], "sweep": sweep["b2"], "stages_max_abs_err": stages["b2_max_abs_err"],
         "block": {k: block[k] for k in ("window_ms", "launches_per_window", "peak_mb",
                                         "b2_block_batch", "b2_block_max_abs_err")}},
        {"name": "cascaded_cfar2d", "route": "cuda",
         "source": "radar_signal_process_tpu_torch/kernels/csrc/cfar.cu",
         "replaces": "radar_signal_process_tpu/kernels/cfar_pallas.py:136",
         "launches": sum(b1_launches.values()), "launches_by_path": b1_launches,
         **cfar_stats, "max_abs_err": max(cfar_stats["max_abs_err"], cfar_g0_stats["max_abs_err"],
                                          sweep["b1"]["max_abs_err"]),
         "g0": cfar_g0_stats, "sweep": sweep["b1"],
         "stages_mismatched_flags": stages["b1_mismatched_flags"],
         "extended_blocks": mesh["b1_blocks"], "mesh_window_ms": mesh["window_ms"],
         "native_cascade_ms_per_rdm": block["native_ms_per_rdm"],
         "native_cascade_pool_ms_per_rdm": block["native_pool_ms_per_rdm"],
         "host_cpus": block["host_cpus"]},
        {"name": "fused_pc_rdm", "route": "cuda",
         "source": "radar_signal_process_tpu_torch/kernels/csrc/pc_rdm.cu",
         "replaces": "radar_signal_process_tpu/kernels/pc_rdm_pallas.py:253",
         "launches": (g0["launches"]["fused_pc_rdm"] + g0["outputs"]["launches"]["fused_pc_rdm"]
                      + bench_launches["g0"]["fused_pc_rdm"]),
         "launches_by_path": {"dmx": g0["launches"]["fused_pc_rdm"],
                              "dmx outputs": g0["outputs"]["launches"]["fused_pc_rdm"],
                              "bench g0": bench_launches["g0"]["fused_pc_rdm"]},
         **b3_stats},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

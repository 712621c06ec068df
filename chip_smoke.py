#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radar_signal_process_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one line (or a few), any failure exits non-zero:

1. device  — ``nvidia-smi`` name and power limit, torch/CUDA versions; exits
   non-zero at once when ``torch.cuda.is_available()`` is false;
2. build   — compiles ``kernels/csrc/*.cu`` with nvcc for sm_90a;
3. B2      — the RDM-former kernel against its plain matmul version (and the
   cuFFT form) at G2 geometry, 52 x 332 x 3404, f32 tolerance;
4. B1      — the cascaded-CFAR kernel against its plain version, bit for bit,
   on the B2 output (three G2 segments, after the divisor-20 re-notch) and
   on a crafted RDM (notched rows, ties, edge columns, a cell exactly on the
   threshold, no range pass, E=2, smallest-of);
5. slice   — writes a seeded 4-frame 16-channel G2 capture with one point
   target and runs ``radar_signal_process_tpu_torch.cli stream`` over it at
   full width (13 beams, win_size 4, 3 windows) with the CLI's default
   ``.bin`` reader; checks both kernels ran,
   the RDMs are finite and agree with the plain versions, and the target is
   detected in the beam it steers to; times each stage with CUDA events.

The line before the last is a JSON summary of the kernels; the last line is
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

SEED = 20250817
G2_BATCH, G2_PULSES, G2_RANGE = 52, 332, 3404
RDM_RTOL, RDM_ATOL = 2e-4, 2e-3   # the repo's f32 RDM tolerance
TARGET_V, TARGET_R = -5.7, 320.0  # m/s, m: the known-good G2 drive
REPS = 10


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


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
    ms = cuda_ms({"kernel": run_kernel, "plain": run_plain, "cufft": run_fft})
    print(f"B2 doppler_rdm {shape}: max_abs_err {max_abs:.3e} max_rel_err "
          f"{max_rel:.3e} vs plain (rtol {RDM_RTOL}, atol {RDM_ATOL}) -> "
          f"{'ok' if ok else 'FAIL'}; vs cuFFT -> {'ok' if ok_fft else 'FAIL'}; "
          f"median ms kernel {ms['kernel']:.3f} plain-matmul {ms['plain']:.3f} "
          f"cufft {ms['cufft']:.3f}")
    if not (ok and ok_fft):
        fail("B2: kernel disagrees with its plain version")
    del want, fft, pc
    return {"max_abs_err": max_abs, "ms": ms["kernel"], "plain_ms": ms["plain"],
            "cufft_ms": ms["cufft"]}, got


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


def crafted_rdm(shape, rng, n_clutter: int, segments) -> np.ndarray:
    """RDM with notched zero rows, exact neighbour ties, segment-edge hits and
    a cell exactly on its CFAR threshold."""
    b, nv, nr = shape
    rdm = (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    c = nv // 2 - 1
    rdm[:, c - 17 : c + 18, :] = 0.0               # divisor-20 re-notch band
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
    rdm[0, lo + 40 : lo + 80, 300:340] = v
    rdm[0, lo + 60, 320] = x
    return rdm


def phase_cfar(dev, rdm_b2: torch.Tensor) -> dict:
    import dataclasses

    from radar_signal_process_tpu_torch.config import G2_PROFILE as prof
    from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d
    from radar_signal_process_tpu_torch.models.detect import clutter_cells
    from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
    from radar_signal_process_tpu_torch.params import chain_params

    segments = prof.cfar_segments
    n_clutter = clutter_cells(prof, G2_PULSES)
    mask = chain_params(prof, device=dev).renotch_mask
    rdm_n = (rdm_b2 * mask[:, None]).contiguous()
    cfg = prof.cfar
    cases = [("B2 output, renotch /20", rdm_n, cfg)]
    crafted = torch.from_numpy(
        crafted_rdm((4, G2_PULSES, G2_RANGE), np.random.default_rng(SEED + 1),
                    n_clutter, segments)
    ).to(dev)
    cases += [
        ("crafted", crafted, cfg),
        ("crafted range_detect=False", crafted, dataclasses.replace(cfg, range_detect=False)),
        ("crafted E=2", crafted, dataclasses.replace(cfg, range_extend_cells=2)),
        ("crafted SO", crafted, dataclasses.replace(cfg, method=1)),
    ]
    max_abs, mismatched = 0.0, 0
    for label, x, c in cases:
        kf, kv = cascaded_cfar2d(x, c, n_clutter, segments)
        pf, pv = segmented_cfar(x, segments, c, n_clutter)
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
    ms = cuda_ms({
        "kernel": lambda: cascaded_cfar2d(rdm_n, cfg, n_clutter, segments),
        "plain": lambda: segmented_cfar(rdm_n, segments, cfg, n_clutter),
    })
    print(f"B1 timing {tuple(rdm_n.shape)} 3 segments: median ms kernel "
          f"{ms['kernel']:.3f} plain {ms['plain']:.3f}")
    return {"max_abs_err": max_abs, "mismatched_flags": mismatched,
            "ms": ms["kernel"], "plain_ms": ms["plain"]}


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
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, detect_rdm
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

        def on_result(res):
            stamps.append(time.perf_counter())
            if not bool(torch.isfinite(res.rdms).all()):
                fail(f"slice: non-finite RDM in window {res.frame_idx}")
            d = res.detections
            hit = (d.valid[beam] & ((d.v_idx[beam] - row).abs() <= 1)
                   & ((d.r_idx[beam] - col).abs() <= 1)).any(dim=-1)
            found.append(hit.cpu().tolist())
            if not first:
                first.update(idx=res.frame_idx, rdms=res.rdms, flags=res.flags)

        argv = ["stream", "--input", cap, "--profile", "G2", "--frames", "4",
                "--win-size", "4", "--dbf-coeffs", coeff_path, "--emit", "full",
                "--device", "cuda"]
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
        pf, _ = segmented_cfar(got * params.renotch_mask[:, None], prof.cfar_segments,
                               prof.cfar, n_clutter)
        flags_ok = torch.equal(pf, first["flags"])
        print(f"slice: window {first['idx']} RDM vs plain max_abs_err "
              f"{float((got - want).abs().max()):.3e} (peak {peak:.3e}) -> "
              f"{'ok' if rdm_ok else 'FAIL'}; "
              f"flags vs plain CFAR on the returned RDM -> "
              f"{'bit-identical' if flags_ok else 'MISMATCH'}")
        if not (rdm_ok and flags_ok):
            fail("slice: stream output disagrees with the plain versions")

        rdm = krdm.doppler_rdm(pc, params.dft_re, params.dft_im, notch)
        flags, _ = detect_rdm(rdm, prof, n_clutter, params.renotch_mask)
        ms = cuda_ms({
            "dbf": lambda: stage(host[1]),
            "pc": lambda: segmented_pulse_compression(
                win, prof, params.pc_spectra, params.pc_filter_lens),
            "rdm": lambda: krdm.doppler_rdm(pc, params.dft_re, params.dft_im, notch),
            "cfar": lambda: detect_rdm(rdm, prof, n_clutter, params.renotch_mask),
            "extract": lambda: extract_detections(flags, rdm, 16),
        }, reps=5)
        print("slice: stage median ms (CUDA events, one window; dbf per frame): "
              + " ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" | sum {sum(ms.values()):.3f} | host .bin parse "
              f"{parse_ms:.1f} ms/frame ({reader_cls.__name__}, wall clock)")
    return launches


def main() -> int:
    name = phase_device()
    dev = torch.device("cuda:0")
    from radar_signal_process_tpu_torch.device import resolve_device

    resolve_device(dev)
    phase_build()
    rdm_stats, rdm_out = phase_rdm(dev)
    cfar_stats = phase_cfar(dev, rdm_out)
    del rdm_out
    launches = phase_slice(dev)
    kernels = [
        {"name": "doppler_rdm", "route": "cuda",
         "source": "radar_signal_process_tpu_torch/kernels/csrc/rdm.cu",
         "replaces": "radar_signal_process_tpu/kernels/rdm_pallas.py:114",
         "launches": launches["doppler_rdm"], **rdm_stats},
        {"name": "cascaded_cfar2d", "route": "cuda",
         "source": "radar_signal_process_tpu_torch/kernels/csrc/cfar.cu",
         "replaces": "radar_signal_process_tpu/kernels/cfar_pallas.py:136",
         "launches": launches["cascaded_cfar2d"], **cfar_stats},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

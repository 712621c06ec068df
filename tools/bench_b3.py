#!/usr/bin/env python3
"""B3's device time on one GPU at the G0 chain's shapes.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/bench_b3.py [--root DIR] [--reps 20] [--cuts]

``--root`` imports ``radar_signal_process_tpu_torch`` from another checkout
(e.g. the parent commit unpacked with ``git archive`` into a gitignored
directory), so two versions of B3 can be timed on one card by running this
script once per checkout, in turns.  On a seeded G0 frame (two beams of
1536 x 566 complex64, the segments read in place from them, the operators of
``G0Chain``), for the short segment (62 -> 62 columns), the long one
(504 -> 512) and the frame (``G0Chain.front``, both), it prints beside
``nvidia-smi``'s name and power limit: the median ms of
``kernels.pc_rdm.fused_pc_rdm`` (CUDA events around each call, calls in
turns with the others; the wrapper's host time is inside) and its device
time (a CUDA graph of 20 calls, ``chip_smoke.graph_ms``); the same two of
its plain version (two cuBLAS complex64 matmuls and ``abs``, the library
calls that compute the same function); the median ms of the cuFFT form
(``G0Chain``'s FFT pulse compression and slow-time FFT, per segment as
``front_fft`` forms it; it copies a filter spectrum from the host each
call, so it takes no graph); B3's bound from the checkout's
``kernels/cost_model.py`` and the device time's share of it; its FP32-equivalent TFLOP/s; its max error
against the complex128 product as a share of the peak; and the device time
of the operator's preparation (``kernels.pc_rdm.pc_operator_image``, a CUDA
graph), where the checkout has one.

``--cuts`` then builds ``csrc/pc_rdm.cu`` with one part removed at a time
(the wgmma products; the X copies; the W copies; the P hand-off: phase 1
stores no P and phase 2 reads one image stage over and over; phase 1 alone;
phase 2 alone), with a ring of 5 stages in place of 6, and with the short
segment's phase 2 in blocks of two warpgroups,
beside the unchanged source and times each segment's device time in three
rounds of turns: what is left when a part is gone says what bounds the
kernel.  A cut's output is wrong by design; only its time is read.
The last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SEED = 20250817
WGMMAS = """  wgmma_m64n96k8_tf32<kFirst ? 0 : 1>(p, f.rl, b_hi);
  wgmma_m64n96k8_tf32<1>(p, f.rh, b_lo);
  wgmma_m64n96k8_tf32<1>(p, f.il, bn_hi);
  wgmma_m64n96k8_tf32<1>(p, f.ih, bn_lo);
  wgmma_m64n96k8_tf32<1>(p, f.rh, b_hi);
  wgmma_m64n96k8_tf32<1>(p, f.ih, bn_hi);
"""
P_STORES = """      uint32_t hi, lo;
      split(-im, hi, lo);
      dst[0] = __uint_as_float(hi);
      dst[kPartFloats] = __uint_as_float(lo);
      split(re, hi, lo);
      dst[kSubFloats] = __uint_as_float(hi);
      dst[kPartFloats + kSubFloats] = __uint_as_float(lo);
      split(im, hi, lo);
      dst[2 * kSubFloats] = __uint_as_float(hi);
      dst[kPartFloats + 2 * kSubFloats] = __uint_as_float(lo);
"""
PHASE2_LOOP = """  main_loop<kWG>(smem, full, a.b_img + static_cast<size_t>(blockIdx.y) * n_kt * kImageStageFloats,
                 kImageStageFloats, n_kt, a.a_tma ? 2 * kPlane : 0, load_a, frag, acc);"""
PHASE2_LAUNCH = """  return static_cast<int>(blocks2 >= n_sms ? launch_rdm<2>(a, w_tma, st)
                                           : launch_rdm<1>(a, w_tma, st));"""
# cut name -> (old, new) replacements in csrc/pc_rdm.cu
CUTS = {
    "no products": [(WGMMAS, "")],
    "no X copies": [
        ("      if (tid == 0) tma_load_3d(st, &maps.a0, 2 * kBK * kt, p0, b, bar);\n", ""),
        ("kImageStageFloats, n_kt, a.a_tma ? S::kABytes : 0, load_a, frag, acc);",
         "kImageStageFloats, n_kt, 0, load_a, frag, acc);")],
    "no W copies": [
        ("        tma_load_2d(st, &maps.a0, kBK * kt, d0, bar);\n"
         "        tma_load_2d(st + kPlane, &maps.a1, kBK * kt, d0, bar);\n", ""),
        ("kImageStageFloats, n_kt, a.a_tma ? 2 * kPlane : 0, load_a, frag, acc);",
         "kImageStageFloats, n_kt, 0, load_a, frag, acc);")],
    "no P hand-off": [
        (P_STORES, "      (void)dst;\n"),
        (PHASE2_LOOP, PHASE2_LOOP.replace(
            "a.b_img + static_cast<size_t>(blockIdx.y) * n_kt * kImageStageFloats,\n"
            "                 kImageStageFloats,", "a.b_img,\n                 0,"))],
    "phase 1 alone": [(PHASE2_LAUNCH, "  (void)blocks2;\n  return 0;")],
    "phase 2 alone": [
        ("  pc_kernel<<<grid1, Shape<2>::kThreads, Shape<2>::kSmem, st>>>(maps, a);\n", "")],
    "ring of 5": [("constexpr int kStages = 6;", "constexpr int kStages = 5;")],
    "phase 2 in 2-warpgroup blocks": [(PHASE2_LAUNCH, "  (void)blocks2;\n"
                                      "  return static_cast<int>(launch_rdm<2>(a, w_tma, st));")],
}


def _median_ms(fns: dict, reps: int) -> dict:
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in times.items()}


def _cufft_forms(chain, beams) -> dict:
    """``G0Chain.front_fft`` per segment: the FFT pulse compression of
    ``G0Chain.pc``, then the windowed, unshifted, zero-padded slow-time FFT
    and the magnitude."""
    from radar_signal_process_tpu_torch.models import g0_chain as g0
    from radar_signal_process_tpu_torch.ops.mtd import doppler_process

    ps = chain.profile.segment_points[0]
    window = chain.mtd_window.double().cpu().numpy()
    n_fft = chain.chain.mtd_fft_length

    def short():
        spec = torch.as_tensor(g0.fir_spectrum(ps, normalize=False), dtype=g0.COMPLEX,
                               device=beams.device)
        mf = g0.fir_compress(beams[..., :ps], spec, len(g0.NARROW_PULSE_FIR_TAPS),
                             post_scale=1.0, roll_group_delay=False)
        return doppler_process(mf, window, n_fft, shift=False)

    def long():
        mf = g0.fixed_length_matched_filter(beams[..., ps:], chain.match_spec)
        return doppler_process(mf, window, n_fft, shift=False)

    return {"short": short, "long": long}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cuts", action="store_true", help="time pc_rdm.cu with parts removed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_b3: no GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.append(str(REPO))  # chip_smoke.graph_ms; the package comes from --root
    import chip_smoke
    from radar_signal_process_tpu_torch.kernels import cost_model
    from radar_signal_process_tpu_torch.kernels import pc_rdm as kpcr
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    chain = G0Chain(device=dev)
    prof = chain.profile
    rng = np.random.default_rng(SEED)
    x = np.empty((2, prof.prt_per_frame, prof.point_prt), np.complex64)
    x.real = rng.standard_normal(x.shape, dtype=np.float32)
    x.imag = rng.standard_normal(x.shape, dtype=np.float32)
    beams = torch.from_numpy(x).to(dev)
    ps = prof.segment_points[0]
    w_re, w_im = chain.dft_re, chain.dft_im
    segments = {"short": (beams[..., :ps], chain.pc_short_re, chain.pc_short_im),
                "long": (beams[..., ps:], chain.pc_long_re, chain.pc_long_im)}
    cufft = _cufft_forms(chain, beams)
    result = {"root": args.root, "pc_rdm_py": kpcr.__file__, "smi": smi, "segments": {}}
    kernels = {}
    for name, (seg, m_re, m_im) in segments.items():
        fns = {"kernel": lambda seg=seg, m_re=m_re, m_im=m_im: kpcr.fused_pc_rdm(
                   seg, m_re, m_im, w_re, w_im),
               "plain": lambda seg=seg, m_re=m_re, m_im=m_im: kpcr.fused_pc_rdm_plain(
                   seg, m_re, m_im, w_re, w_im),
               "cufft": cufft[name]}
        kernels[name] = fns["kernel"]
        got = fns["kernel"]()
        c128 = torch.complex128
        exact = torch.matmul(torch.complex(w_re, w_im).to(c128),
                             torch.matmul(seg.to(c128), torch.complex(m_re, m_im).to(c128))).abs()
        err = float((got.double() - exact).abs().max() / exact.abs().max())
        del exact, got
        ms = _median_ms(fns, args.reps)
        dev_ms = {k: chip_smoke.graph_ms(fns[k]) for k in ("kernel", "plain")}
        prep = (chip_smoke.graph_ms(lambda m_re=m_re, m_im=m_im: kpcr.pc_operator_image(m_re, m_im))
                if hasattr(kpcr, "pc_operator_image") else None)
        c = cost_model.fused_pc_rdm_cost(2, prof.prt_per_frame, *m_re.shape, w_re.shape[0])
        row = {"shape": [2, prof.prt_per_frame, *m_re.shape, w_re.shape[0]],
               "kernel_ms": ms["kernel"], "device_ms": dev_ms["kernel"],
               "plain_ms": ms["plain"], "plain_device_ms": dev_ms["plain"],
               "cufft_ms": ms["cufft"],
               "prep_device_ms": prep, "bound_ms": c["sol_s"] * 1e3, "bound_by": c["bound_by"],
               "flops": c["flops"], "error_vs_c128": err}
        result["segments"][name] = row
        torch.cuda.empty_cache()
    frame = {k: sum(r[k] for r in result["segments"].values())
             for k in ("bound_ms", "flops")}
    fns = {"kernel": lambda: chain.front(beams), "cufft": lambda: chain.front_fft(beams)}
    ms = _median_ms(fns, args.reps)
    frame.update({"kernel_ms": ms["kernel"], "device_ms": chip_smoke.graph_ms(fns["kernel"]),
                  "cufft_ms": ms["cufft"],
                  "bound_by": "operations",
                  "error_vs_c128": max(r["error_vs_c128"] for r in result["segments"].values())})
    for k in ("plain_ms", "plain_device_ms"):
        frame[k] = sum(r[k] for r in result["segments"].values())
    prep = [r["prep_device_ms"] for r in result["segments"].values()]
    frame["prep_device_ms"] = None if None in prep else sum(prep)
    result["segments"]["frame"] = frame
    for name, row in result["segments"].items():
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["fp32_eq_tflops"] = row["flops"] / cost_model.TF32_SPLIT / row["device_ms"] / 1e9
        prep_txt = "none" if row["prep_device_ms"] is None else f"{row['prep_device_ms']:.4f}"
        print(f"B3 {name}: kernel {row['kernel_ms']:.4f} ms a call, device {row['device_ms']:.4f} "
              f"({row['fp32_eq_tflops']:.1f} FP32-eq TFLOP/s, {100 * row['share_of_bound']:.1f}% of "
              f"the {row['bound_ms']:.4f} ms bound by {row['bound_by']}); plain (two cuBLAS "
              f"CGEMMs + abs) {row['plain_ms']:.4f} / device {row['plain_device_ms']:.4f}; cuFFT "
              f"form {row['cufft_ms']:.4f} a call; operator "
              f"preparation (device) {prep_txt}; error/peak vs complex128 "
              f"{row['error_vs_c128']:.3e} | {smi}")
    if args.cuts:
        result["cuts_device_ms"] = _cuts(kernels)
    print(json.dumps(result))
    return 0


def _cuts(kernels: dict) -> dict:
    """Device ms of each segment's B3 built with each of CUTS, beside the
    unchanged source, in three rounds of turns."""
    import chip_smoke
    from radar_signal_process_tpu_torch.kernels import _build

    src = (_build.CSRC / "pc_rdm.cu").read_text()
    csrc, build_dir, lib0 = _build.CSRC, _build.BUILD_DIR, _build._lib
    times: dict = {}
    with tempfile.TemporaryDirectory(prefix="bench_b3_") as tmp:
        libs = {}
        for name, edits in {"unchanged": [], **CUTS}.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"cut {name}: source text not found: {old[:60]!r}")
                text = text.replace(old, new)
            d = pathlib.Path(tmp) / name.replace(" ", "_")
            shutil.copytree(csrc, d)
            (d / "pc_rdm.cu").write_text(text)
            _build.CSRC, _build.BUILD_DIR, _build._lib = d, d / "_build", None
            libs[name] = _build.library()
        try:
            for _ in range(3):
                for name, lib in libs.items():
                    _build._lib = lib
                    for seg, run in kernels.items():
                        times.setdefault(name, {}).setdefault(seg, []).append(
                            chip_smoke.graph_ms(run))
        finally:
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, lib0
    for name, by_seg in times.items():
        print(f"B3 cut {name}: device ms " + "; ".join(
            f"{seg} " + " ".join(f"{x:.4f}" for x in t) for seg, t in by_seg.items()))
    return times


if __name__ == "__main__":
    sys.exit(main())

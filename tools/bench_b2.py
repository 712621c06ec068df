#!/usr/bin/env python3
"""B2's device time on one GPU at the shapes of its main-path callers.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/bench_b2.py [--root DIR] [--reps 20] [--cuts]

``--root`` imports ``radar_signal_process_tpu_torch`` from another checkout
(e.g. the parent commit unpacked with ``git archive`` into a gitignored
directory), so two versions of B2 can be timed on one card by running this
script once per checkout, in turns.  For each shape (G2 52 x 332 x 3404, the
sweep's batch 4 x 332 x 3404, G1 2 x 1536 x 1536 x 868) it prints, beside
``nvidia-smi``'s name and power limit: the median ms of
``kernels.rdm.doppler_rdm`` (CUDA events around each call, calls in turns
with the others; the wrapper's host time is inside) and its device time (a
CUDA graph of 20 calls, ``chip_smoke.graph_ms``), of its plain version, and of the one PyTorch call that
computes the complex product (``torch.matmul(torch.complex(w_re, w_im),
pc)``, no magnitude or notch); B2's bound from the checkout's
``kernels/cost_model.py``; its FP32-equivalent TFLOP/s and its share of the
bound; its max error against the complex128 product as a share of the peak;
and the device time of the W split alone (``kernels.rdm.wgmma_b_planes``,
a CUDA graph), where the checkout has it.

``--cuts`` then builds ``csrc/rdm.cu`` with one part removed (the W bulk
copies, the X copies, the wgmma products), and with a ring of 4 stages in
place of 5 (2 in flight ahead), beside the unchanged source and times each
at G2, in turns: what is left when a part is gone says what bounds the
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
SHAPES = {"g2": (52, 332, 3404), "sweep": (4, 332, 3404), "g1": (2, 1536, 868)}
SEED = 20250817
WGMMAS = """    wgmma_m64n96k8_tf32<kAcc>(p, f.rl, br_hi);
    wgmma_m64n96k8_tf32<1>(p, f.rh, br_lo);
    wgmma_m64n96k8_tf32<1>(p, f.il, bi_hi);
    wgmma_m64n96k8_tf32<1>(p, f.ih, bi_lo);
    wgmma_m64n96k8_tf32<1>(p, f.rh, br_hi);
    wgmma_m64n96k8_tf32<1>(p, f.ih, bi_hi);
"""
CUTS = {
    "no W copies": ("""      mbar_arrive_expect_tx(&full[slot], kWStageBytes);
      bulk_g2s(st, wt + static_cast<size_t>(kt) * kWStageFloats, kWStageBytes, &full[slot]);""",
                    "      mbar_arrive_expect_tx(&full[slot], 0);"),
    "no X copies": ("        cp_async16(sx + kk * kLdX + q, xb + off, bytes);", ""),
    "no products": (WGMMAS, ""),
    "ring of 4": ("constexpr int kStages = 5;", "constexpr int kStages = 4;"),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cuts", action="store_true", help="time rdm.cu with parts removed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_b2: no GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.append(str(REPO))  # chip_smoke.graph_ms; the package comes from --root
    import chip_smoke
    from radar_signal_process_tpu_torch.kernels import cost_model
    from radar_signal_process_tpu_torch.kernels import rdm as krdm
    from radar_signal_process_tpu_torch.ops.windows import make_window

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    result = {"root": args.root, "rdm_py": krdm.__file__, "smi": smi, "shapes": {}}
    for name, (batch, n, nr) in SHAPES.items():
        x = np.empty((batch, n, nr), np.complex64)
        x.real = rng.standard_normal(x.shape, dtype=np.float32)
        x.imag = rng.standard_normal(x.shape, dtype=np.float32)
        pc = torch.from_numpy(x).to(dev)
        del x
        w_re, w_im = (torch.from_numpy(p).to(dev) for p in
                      krdm.dft_planes(make_window("kaiser", n, 8.0)))
        notch = (n // 2 - 1 - round(n / 150), n // 2 - 1 + round(n / 150))
        w = torch.complex(w_re, w_im)
        fns = {"kernel": lambda: krdm.doppler_rdm(pc, w_re, w_im, notch),
               "plain": lambda: krdm.doppler_rdm_plain(pc, w_re, w_im, notch),
               "library": lambda: torch.matmul(w, pc)}
        got = fns["kernel"]()
        exact = torch.matmul(w.to(torch.complex128), pc.to(torch.complex128)).abs()
        exact[:, notch[0] : notch[1] + 1] = 0.0
        err = float((got.double() - exact).abs().max() / exact.abs().max())
        del exact, got
        ms = _median_ms(fns, args.reps)
        ms["device"] = chip_smoke.graph_ms(fns["kernel"])
        if hasattr(krdm, "wgmma_b_planes"):
            ms["split"] = chip_smoke.graph_ms(lambda: krdm.wgmma_b_planes(w_re, w_im))
        c = cost_model.rdm_former_cost(batch, n, nr)
        flops = c["flops"] / cost_model.TF32_SPLIT  # the FP32-equivalent work
        row = {"shape": [batch, n, nr], "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
               "device_ms": ms["device"], "library_ms": ms["library"],
               "split_ms": ms.get("split"),
               "bound_ms": c["sol_s"] * 1e3,
               "bound_by": c["bound_by"], "fp32_eq_tflops": flops / ms["kernel"] / 1e9,
               "share_of_bound": c["sol_s"] * 1e3 / ms["kernel"], "error_vs_c128": err}
        result["shapes"][name] = row
        print(f"B2 {name} {batch} x {n} x {nr}: kernel {row['kernel_ms']:.4f} ms "
              f"({row['fp32_eq_tflops']:.1f} FP32-eq TFLOP/s, {100 * row['share_of_bound']:.1f}% "
              f"of the {row['bound_ms']:.4f} ms bound), device {row['device_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, W split alone (device) "
              f"{row['split_ms']}; error/peak {err:.3e} | {smi}")
        if args.cuts and name == "g2":
            result["cuts_g2_ms"] = _cuts(fns["kernel"], args.reps)
        del pc, fns, w
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


def _cuts(run, reps: int) -> dict:
    """G2 ms of B2 built with each of CUTS, beside the unchanged source, in
    three rounds of turns."""
    from radar_signal_process_tpu_torch.kernels import _build

    src = (_build.CSRC / "rdm.cu").read_text()
    csrc, build_dir, lib0 = _build.CSRC, _build.BUILD_DIR, _build._lib
    times: dict = {}
    with tempfile.TemporaryDirectory(prefix="bench_b2_") as tmp:
        libs = {}
        for name, (old, new) in {"unchanged": ("", ""), **CUTS}.items():
            if old and old not in src:
                raise RuntimeError(f"cut {name}: source text not found")
            d = pathlib.Path(tmp) / name.replace(" ", "_")
            shutil.copytree(csrc, d)
            (d / "rdm.cu").write_text(src.replace(old, new) if old else src)
            _build.CSRC, _build.BUILD_DIR, _build._lib = d, d / "_build", None
            libs[name] = _build.library()
        try:
            for _ in range(3):
                for name, lib in libs.items():
                    _build._lib = lib
                    times.setdefault(name, []).append(_median_ms({name: run}, reps)[name])
        finally:
            _build.CSRC, _build.BUILD_DIR, _build._lib = csrc, build_dir, lib0
    for name, t in times.items():
        print(f"B2 G2 cut {name}: ms " + " ".join(f"{x:.4f}" for x in t))
    return times


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where B1's time goes on one GPU: band lengths, host time, phase cuts.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/bench_b1.py

Prints, on the G2 (52 x 332 x 3404, three segments) and G0 (2048 x 62 and
2048 x 512) shapes:

* the device time of ``kernels.cfar.cascaded_cfar2d`` (a CUDA graph of 20
  calls, ``chip_smoke.graph_ms``) for several band lengths, each checked
  bit for bit against the plain version, the G2 lengths timed in
  interleaved rounds;
* the host time of one wrapper call (enqueue only) beside the device time;
* phase cuts: the same kernel built from ``csrc/cfar.cu`` with one part
  removed (the IEEE division replaced by a product, the flag stores, the
  two barriers), timed beside the unchanged source, and the range pass
  switched off by configuration.  A cut's output is wrong by design; only
  its time is read.

Imports only the port and ``chip_smoke``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE  # noqa: E402
from radar_signal_process_tpu_torch.kernels import _build  # noqa: E402
from radar_signal_process_tpu_torch.kernels import cfar as kcfar  # noqa: E402
from radar_signal_process_tpu_torch.ops import cfar as tcfar  # noqa: E402

G2_SEGMENTS, G2_CLUTTER, G0_CLUTTER = G2_PROFILE.cfar_segments, 13, 6
CUTS = {
    "division": ("mean[k] = __fdiv_rn(acc, rf);", "mean[k] = __fmul_rn(acc, 0.2f);"),
    "stores": ("        flags[o_next] = range_detect ? s_fo[k * TX + tx] : vf[k];\n"
               "        vflags[o_next] = vf[k];\n", ""),
    "barriers": ("    __syncthreads();  // every", "    // every"),
}


def with_band_rows(band_rows):
    """``kcfar._launch_table`` with the plan's band length replaced."""
    real = kcfar._launch_table

    def table(segments, nvu, batch, cfg, n_sms):
        plan, tab = real(segments, nvu, batch, cfg, n_sms)
        if band_rows is None:
            return plan, tab
        n_bands = -(-nvu // band_rows)
        rows, first = [], 0
        for a, w, _ in plan.table:
            rows.append((a, w, first))
            first += -(-w // plan.tx) * n_bands
        tab = (ctypes.c_int * (3 * len(rows) + 1))(
            *(x[0] for x in rows), *(x[1] for x in rows), *(x[2] for x in rows), first)
        return plan._replace(band_rows=band_rows, n_bands=n_bands, n_blocks=first,
                             table=tuple(rows)), tab
    return table


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_b1: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(smi())
    rng = np.random.default_rng(chip_smoke.SEED)
    g2 = torch.from_numpy(chip_smoke.crafted_rdm(
        (52, 332, 3404), rng, G2_CLUTTER, G2_SEGMENTS)).to(dev)
    g0 = {nr: torch.from_numpy(chip_smoke.crafted_rdm(
        (1, 2048, nr), rng, G0_CLUTTER, ((0, nr),), unshifted=True)[0]).to(dev)
        for nr in (62, 512)}
    cfg2, cfg0 = G2_PROFILE.cfar, G0_PROFILE.cfar

    def run_g2(cfg=cfg2):
        return kcfar.cascaded_cfar2d(g2, cfg, G2_CLUTTER, G2_SEGMENTS)

    want = tcfar.segmented_cfar(g2, G2_SEGMENTS, cfg2, G2_CLUTTER)
    real = kcfar._launch_table

    # band lengths: G2 in interleaved rounds, G0 each once
    plan = real(G2_SEGMENTS, 303, 52, cfg2, torch.cuda.get_device_properties(dev)
                .multi_processor_count)[0]
    print(f"G2 plan: strips of {plan.tx} columns, {plan.threads} threads, bands of "
          f"{plan.band_rows} rows, {plan.n_blocks * 52} blocks, {plan.smem} B shared memory")
    times: dict = {}
    for rnd in range(3):
        for band_rows in (303, 152, 101, 76, 51):
            kcfar._launch_table = with_band_rows(band_rows)
            if rnd == 0:
                got = run_g2()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    print(f"G2 band {band_rows}: MISMATCH", file=sys.stderr)
                    return 1
            times.setdefault(band_rows, []).append(chip_smoke.graph_ms(run_g2))
    for band_rows, t in times.items():
        print(f"B1 G2 bands of {band_rows} rows: device ms " + " ".join(f"{x:.4f}" for x in t))
    for nr, x in g0.items():
        want0 = tcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER)
        line = []
        for band_rows in (None, 4, 8, 16, 32):
            kcfar._launch_table = with_band_rows(band_rows)
            got = kcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER)
            ok = torch.equal(got[0], want0[0]) and torch.equal(got[1], want0[1])
            t = chip_smoke.graph_ms(lambda x=x: kcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER))
            line.append(f"{band_rows or 'plan'} {t:.4f}{'' if ok else ' MISMATCH'}")
        print(f"B1 G0 2048 x {nr}, device ms by band rows: " + ", ".join(line))
    kcfar._launch_table = real

    # host time of one call
    for name, fn in (("G2", run_g2),
                     ("G0 short", lambda: kcfar.cascaded_cfar2d(g0[62], cfg0, G0_CLUTTER))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / 50
        torch.cuda.synchronize()
        ms = chip_smoke.cuda_ms({"call": fn})["call"]
        print(f"B1 {name}: host enqueue {host:.4f} ms a call, CUDA events around a call "
              f"{ms:.4f} ms, device {chip_smoke.graph_ms(fn):.4f} ms")

    # phase cuts, each built beside the unchanged source and timed in turns
    src = (_build.CSRC / "cfar.cu").read_text()
    csrc = _build.CSRC
    with tempfile.TemporaryDirectory(prefix="bench_b1_") as tmp:
        libs = {}
        for name, (old, new) in {"unchanged": ("", ""), **CUTS}.items():
            if old and src.count(old) < 1:
                print(f"cut {name}: source text not found", file=sys.stderr)
                return 1
            d = pathlib.Path(tmp) / name
            shutil.copytree(csrc, d)
            (d / "cfar.cu").write_text(src.replace(old, new) if old else src)
            _build.CSRC, _build.BUILD_DIR, _build._lib = d, d / "_build", None
            libs[name] = _build.library()
        cut_ms: dict = {}
        for _ in range(3):
            for name, lib in libs.items():
                _build._lib = lib
                cut_ms.setdefault(name, []).append(chip_smoke.graph_ms(run_g2))
            _build._lib = libs["unchanged"]
            cut_ms.setdefault("range pass off", []).append(chip_smoke.graph_ms(
                lambda: run_g2(dataclasses.replace(cfg2, range_detect=False))))
    for name, t in cut_ms.items():
        print(f"B1 G2 cut {name}: device ms " + " ".join(f"{x:.4f}" for x in t))
    print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())

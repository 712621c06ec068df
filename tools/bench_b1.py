#!/usr/bin/env python3
"""B1's time on one GPU at the shapes of its main-path callers, and what
bounds it.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/bench_b1.py [--root DIR] [--reps 20] [--cuts] [--plans]

``--root`` imports ``radar_signal_process_tpu_torch`` from another checkout
(e.g. the parent commit unpacked with ``git archive`` into a gitignored
directory), so two versions of B1 can be timed on one card by running this
script once per checkout, in turns.  For each shape (G2 52 x 332 x 3404
with its three segments, the sweep's batch 4 x 332 x 3404, G0's two
segments 2048 x 62 and 2048 x 512) it prints, beside ``nvidia-smi``'s name
and power limit, the time of ``kernels.cfar.cascaded_cfar2d``:

* ``device``: a CUDA graph of 20 calls (``chip_smoke.graph_ms``), so no
  host time of the wrapper is in it;
* ``call``: CUDA events around each call, calls in turns (median);
* ``enqueue``: the host clock over 50 calls without a synchronisation;

at G2 and the sweep's batch for the CFAR stage's two forms: ``fused``, B1
reading the re-notch rows (148, 183) as 0.0 (``zero_rows``, where the
checkout has it), and ``unfused``, the re-notch as a product and then B1 on
it; B1 alone on the re-notched RDM (``b1``); the plain version.  Each is
held bit for bit against the plain version.  The bound is the checkout's
``kernels/cost_model.py`` (bytes at 3.35 TB/s; the fused form's without the
notched rows, where the model takes them).  At G2 it also times B1 over
the halo-extended blocks of sp = 2 and 4 range shards, as they are and
widened to whole 16 bytes a row, against B1 on the whole RDM.

``--cuts`` then builds ``csrc/cfar.cu`` with one part changed (the IEEE
division in place of the exact division by 5; no flag stores; a TMA box a
row in place of a box a step; the ring 8 or 16 rows ahead in place of 4)
beside the unchanged source, and the range pass switched off by
configuration, and times each at G2 (fused) in three rounds of turns.  A
cut's output may be wrong by design; only its time is read.  (Neither the
copies, the mbarrier waits nor the step barrier can be cut alone: a block
would read rows never staged, exit with its copies in flight, or let one
warp run two ring phases ahead of another, which then waits forever and
traps.  The staging is weighed by its alternatives instead.)  ``--plans`` times, at G2 and G0,
other tile widths, band lengths and the cp.async staging path in place of
``kernels.cfar.cfar_plan``'s, each held bit for bit to the plan's flags.
The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SEED = 20250817
G2_SHAPE, SWEEP_BATCH, G2_CLUTTER, G0_CLUTTER = (52, 332, 3404), 4, 14, 6
ZERO_ROWS = (148, 183)   # the G2 divisor-20 re-notch, models.detect.renotch_rows
CUTS = {
    "IEEE division": ("    return div5(x);", "    return __fdiv_rn(x, rf);"),
    "no flag stores": ("        store_flags(a.flags, o, fb);\n        store_flags(a.vflags, o, vb);\n", ""),
    "a box a row": ("const bool whole = SW <= kBox", "const bool whole = false && SW <= kBox"),
    "8 rows ahead": ("constexpr int kPrefetch = 4;", "constexpr int kPrefetch = 8;"),
    "16 rows ahead": ("constexpr int kPrefetch = 4;", "constexpr int kPrefetch = 16;"),
}
CUT_PREFETCH = {"8 rows ahead": 8, "16 rows ahead": 16}   # the plan's mirror of the ring


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def enqueue_ms(fn, n: int = 50) -> float:
    """Host ms a call of ``fn`` takes to enqueue (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cuts", action="store_true", help="time cfar.cu with parts removed")
    ap.add_argument("--plans", action="store_true", help="time other tile widths and bands")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_b1: no GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.append(str(REPO))  # chip_smoke's timers and RDMs; the package comes from --root
    import chip_smoke
    from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar
    from radar_signal_process_tpu_torch.kernels import cost_model
    from radar_signal_process_tpu_torch.ops import cfar as tcfar

    line = smi()
    print(line)
    dev = torch.device("cuda")
    fused = "zero_rows" in inspect.signature(kcfar.cascaded_cfar2d).parameters
    rng = np.random.default_rng(SEED)
    segs2, cfg2, cfg0 = G2_PROFILE.cfar_segments, G2_PROFILE.cfar, G0_PROFILE.cfar
    result = {"root": args.root, "cfar_py": kcfar.__file__, "smi": line, "fused": fused,
              "shapes": {}}

    def equal(got, want) -> bool:
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    g2 = None
    for name, batch in (("g2", G2_SHAPE[0]), ("sweep", SWEEP_BATCH)):
        x = torch.from_numpy(chip_smoke.crafted_rdm(
            (batch,) + G2_SHAPE[1:], rng, G2_CLUTTER, segs2)).to(dev)
        # the re-notch rows hold data in memory; the CFAR stage zeroes them
        x[:, ZERO_ROWS[0] : ZERO_ROWS[1]] = x[:, 20 : 20 + ZERO_ROWS[1] - ZERO_ROWS[0]]
        keep = torch.ones(G2_SHAPE[1], device=dev)
        keep[ZERO_ROWS[0] : ZERO_ROWS[1]] = 0.0
        xn = x * keep[:, None]
        fns = {"unfused": lambda x=x, keep=keep: kcfar.cascaded_cfar2d(
                   x * keep[:, None], cfg2, G2_CLUTTER, segs2),
               "b1": lambda xn=xn: kcfar.cascaded_cfar2d(xn, cfg2, G2_CLUTTER, segs2),
               "plain": lambda xn=xn: tcfar.segmented_cfar(xn, segs2, cfg2, G2_CLUTTER)}
        if fused:
            fns["fused"] = lambda x=x: kcfar.cascaded_cfar2d(x, cfg2, G2_CLUTTER, segs2,
                                                             zero_rows=ZERO_ROWS)
        want = fns["plain"]()
        ok = {k: equal(fn(), want) for k, fn in fns.items() if k != "plain"}
        row = {"shape": [batch, *G2_SHAPE[1:]], "bit_identical": ok,
               "flags": int(want[0].sum()),
               "call_ms": chip_smoke.cuda_ms(fns, args.reps),
               "device_ms": {k: chip_smoke.graph_ms(fn) for k, fn in fns.items() if k != "plain"},
               "enqueue_ms": {k: enqueue_ms(fn) for k, fn in fns.items() if k != "plain"}}
        c = cost_model.cascaded_cfar_cost(batch, *G2_SHAPE[1:], G2_CLUTTER, cfg2)
        row["bound_ms"] = {"b1": c["sol_s"] * 1e3}
        if "notched_rows" in inspect.signature(cost_model.cascaded_cfar_cost).parameters:
            row["bound_ms"]["fused"] = cost_model.cascaded_cfar_cost(
                batch, *G2_SHAPE[1:], G2_CLUTTER, cfg2,
                notched_rows=ZERO_ROWS[1] - ZERO_ROWS[0])["sol_s"] * 1e3
        row["share_of_bound"] = {
            k: row["bound_ms"].get(k, row["bound_ms"]["b1"]) / ms
            for k, ms in row["device_ms"].items() if k in ("b1", "fused")}
        row["gb_per_s"] = {k: c["hbm_bytes"] / 1e6 / ms for k, ms in row["device_ms"].items()}
        result["shapes"][name] = row
        print(f"B1 {name} {tuple(x.shape)}: device ms {row['device_ms']}, call ms "
              f"{row['call_ms']}, enqueue ms {row['enqueue_ms']}, bound {row['bound_ms']}, "
              f"share {row['share_of_bound']}, bit-identical {ok}, flags {row['flags']} | {line}")
        if name == "g2":
            g2 = x
            result["mesh_blocks"] = _mesh_blocks(kcfar, xn, cfg2, segs2, fns["b1"](), line)
        del xn, fns
    g0 = {}
    for nr in (62, 512):
        x = g0[nr] = torch.from_numpy(chip_smoke.crafted_rdm(
            (1, 2048, nr), rng, G0_CLUTTER, ((0, nr),), unshifted=True)[0]).to(dev)
        fns = {"b1": lambda x=x: kcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER),
               "plain": lambda x=x: tcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER)}
        ok = equal(fns["b1"](), fns["plain"]())
        c = cost_model.cascaded_cfar_cost(1, 2048, nr, G0_CLUTTER, cfg0)
        row = {"shape": [2048, nr], "bit_identical": ok, "call_ms": chip_smoke.cuda_ms(fns, args.reps),
               "device_ms": chip_smoke.graph_ms(fns["b1"]), "enqueue_ms": enqueue_ms(fns["b1"]),
               "bound_ms": c["sol_s"] * 1e3}
        result["shapes"][f"g0_{nr}"] = row
        print(f"B1 G0 2048 x {nr}: device {row['device_ms']:.4f} ms, call {row['call_ms']}, "
              f"enqueue {row['enqueue_ms']:.4f}, bound {row['bound_ms']:.5f}, bit-identical {ok} "
              f"| {line}")
    if args.plans and fused:
        result["plans_g2_ms"] = _plans(kcfar, lambda: kcfar.cascaded_cfar2d(
            g2, cfg2, G2_CLUTTER, segs2, zero_rows=ZERO_ROWS), G2_SHAPE[1] - 2 * G2_CLUTTER - 1,
            G2_SHAPE[2], chip_smoke.graph_ms, "G2", G2_VARIANTS)
        for nr, x in g0.items():
            result[f"plans_g0_{nr}_ms"] = _plans(
                kcfar, lambda x=x: kcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER),
                2048 - 2 * G0_CLUTTER - 1, nr, chip_smoke.graph_ms, f"G0 2048 x {nr}", G0_VARIANTS)
    if args.cuts and fused:
        result["cuts_g2_ms"] = _cuts(kcfar, g2, cfg2, segs2, chip_smoke.graph_ms)
    print(smi())
    print(json.dumps(result))
    return 0


def _mesh_blocks(kcfar, xn, cfg, segs, whole, line: str) -> dict:
    """Device ms of B1 over the halo-extended blocks of sp = 2 and 4 range
    shards of the re-notched G2 RDM ``xn``, all blocks of a window in one
    timed run, in two forms: ``local + 2*halo`` columns, and with the right
    halo widened so a row is whole 16 bytes, the table's last segment taking
    the columns (as ``parallel.sharding.sharded_cascaded_cfar2d`` forms them
    where it widens them).  Each form's centres are held bit for bit to B1
    on the whole RDM (``whole``)."""
    import chip_smoke

    nr = xn.shape[-1]
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    out = {}
    for sp in (2, 4):
        local = nr // sp
        for form in ("unwidened", "widened"):
            w = local + 2 * h + (-(local + 2 * h) % 4 if form == "widened" else 0)
            ext = torch.cat([xn[..., -h:], xn, xn[..., : w - local - h]], dim=-1)
            blocks = []
            for s in range(sp):
                table = kcfar.extended_segments(nr, segs, s * local, local, h)
                blocks.append((ext[..., s * local : s * local + w].contiguous(),
                               table[:-1] + ((table[-1][0], w),)))

            def run(blocks=blocks):
                return [kcfar.cascaded_cfar2d(b, cfg, G2_CLUTTER, t) for b, t in blocks]

            parts = run()
            ok = all(torch.equal(torch.cat([p[i][..., h : h + local] for p in parts], -1), whole[i])
                     for i in (0, 1))
            row = out[f"sp{sp} {form}"] = {"shape": list(blocks[0][0].shape), "bit_identical": ok,
                                           "device_ms": chip_smoke.graph_ms(run)}
            print(f"B1 mesh sp = {sp}, {sp} blocks {tuple(row['shape'])} ({form}): device "
                  f"{row['device_ms']:.4f} ms a window, bit-identical to B1 whole {ok} | {line}")
            del ext, blocks, parts
    return out


def _plans(kcfar, run, nvu: int, nr: int, timer, label: str, variants: dict) -> dict:
    """Device ms of B1 with other tile widths, band lengths and staging
    than the plan's (``variants``: name -> (tile width, band rows, TMA),
    None keeping the plan's), in three rounds of turns, each held bit for
    bit to the plan's flags."""
    real = kcfar._launch_table

    def table(sw, band_rows, tma):
        def fn(*key):
            plan, tab = real(*key)
            width, band = sw or plan.sw, band_rows or plan.band_rows
            tx = width - 2 * plan.halo
            n_strips, n_bands = -(-nr // tx), -(-nvu // band)
            return plan._replace(sw=width, tx=tx, threads=width // kcfar.COLS, band_rows=band,
                                 n_strips=n_strips, n_bands=n_bands, n_blocks=n_strips * n_bands,
                                 smem=kcfar.smem_bytes(width, key[3], key[4]),
                                 tma=plan.tma if tma is None else tma), tab
        return fn

    want = run()
    times: dict = {}
    try:
        for rnd in range(3):
            for name, v in {"plan": None, **variants}.items():
                kcfar._launch_table = real if v is None else table(*v)
                if rnd == 0:
                    got = run()
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise RuntimeError(f"plan variant {name}: flags differ")
                times.setdefault(name, []).append(timer(run))
    finally:
        kcfar._launch_table = real
    for name, t in times.items():
        print(f"B1 {label} {name}: device ms " + " ".join(f"{x:.4f}" for x in t))
    return times


G2_VARIANTS = {"tiles of 128": (128, None, None), "tiles of 512": (512, None, None),
               "bands of 303": (None, 303, None), "bands of 152": (None, 152, None),
               "bands of 76": (None, 76, None), "cp.async staging": (None, None, False)}
G0_VARIANTS = {"bands of 4": (None, 4, None), "bands of 16": (None, 16, None),
               "bands of 32": (None, 32, None)}


def _cuts(kcfar, x, cfg, segs, timer) -> dict:
    """G2 device ms of B1 (fused) built with each of CUTS beside the
    unchanged source, and with the range pass off, in three rounds."""
    from radar_signal_process_tpu_torch.kernels import _build

    src = (_build.CSRC / "cfar.cu").read_text()
    csrc, build_dir, lib0 = _build.CSRC, _build.BUILD_DIR, _build._lib
    prefetch0 = kcfar.PREFETCH

    def run(c=cfg):
        return kcfar.cascaded_cfar2d(x, c, G2_CLUTTER, segs, zero_rows=ZERO_ROWS)

    def use(lib, name="unchanged"):  # a library, and the plan's mirror of its ring
        kcfar.PREFETCH = CUT_PREFETCH.get(name, prefetch0)
        kcfar._launch_table.cache_clear()
        _build._lib = lib

    times: dict = {}
    with tempfile.TemporaryDirectory(prefix="bench_b1_") as tmp:
        libs = {}
        for name, (old, new) in {"unchanged": ("", ""), **CUTS}.items():
            if old and old not in src:
                raise RuntimeError(f"cut {name}: source text not found")
            d = pathlib.Path(tmp) / name.replace(" ", "_")
            shutil.copytree(csrc, d)
            (d / "cfar.cu").write_text(src.replace(old, new) if old else src)
            _build.CSRC, _build.BUILD_DIR, _build._lib = d, d / "_build", None
            libs[name] = _build.library()
        try:
            for _ in range(3):
                for name, lib in libs.items():
                    use(lib, name)
                    times.setdefault(name, []).append(timer(run))
                use(libs["unchanged"])
                times.setdefault("range pass off", []).append(
                    timer(lambda: run(dataclasses.replace(cfg, range_detect=False))))
        finally:
            use(lib0)
            _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for name, t in times.items():
        print(f"B1 G2 cut {name}: device ms " + " ".join(f"{x:.4f}" for x in t))
    return times


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""B1's time on one GPU at every shape the port launches it on, and what
bounds it.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/bench_b1.py [--root DIR] [--reps 20] [--cuts] [--plans] [--out FILE]

Flags:

* ``--root DIR`` imports ``radar_signal_process_tpu_torch`` from another
  checkout (e.g. an earlier commit unpacked with ``git archive`` into the
  gitignored ``_checkouts/``), so several versions of B1 are timed on one
  card by running this script once per checkout, in turns (``a b b a``);
* ``--reps N``: calls a median of the per-call timings (default 20);
* ``--plans`` times other plans in place of ``kernels.cfar.cfar_plan``'s
  at each shape (tile widths, the narrow body or the tile body, band
  lengths, the staging path), each held bit for bit to the plan's flags,
  in three rounds of turns;
* ``--cuts`` builds ``csrc/cfar.cu`` with one part changed (the IEEE
  division in place of the exact division by 5; no flag stores; a TMA box
  a row in place of a box a step; the tile body's ring 8 rows ahead in
  place of 4; every block exiting at once, which leaves the launch) beside
  the unchanged source, and times each, and the range pass switched off by
  configuration, at G2, G0's two segments and the sp = 4 mesh blocks, in
  three rounds of turns.  A cut's output may be wrong by design; only its
  time is read.  (Neither the copies, the mbarrier waits nor the step
  barrier can be cut alone: a block would read rows never staged, exit with
  its copies in flight, or let one warp run two ring phases ahead of
  another, which then waits forever and traps.  The staging is weighed by
  its alternatives instead);
* ``--out FILE`` also writes the last line's JSON object to ``FILE``.

The six shapes, each with the form the port's own path launches (``main``)
and its bound from the checkout's ``kernels/cost_model.py`` (bytes at
3.35 TB/s; without the re-notched rows where the form fuses the re-notch):

* ``g2``: a G2 window, 52 x 332 x 3404, three segments;
* ``sweep``: the sweep's batch, 4 x 332 x 3404;
* ``g0_62``, ``g0_512``: G0's short and long segment, 1 x 2048 x 62 and
  x 512 (``models.g0_chain``);
* ``mesh_sp2``, ``mesh_sp4``: the halo-extended blocks of sp = 2 and 4
  range shards of the G2 window (``parallel.sharding``), all blocks of a
  window in one timed run, one launch a block; each block also alone.

At G2, the sweep's batch and the mesh blocks the forms are ``fused`` (the
re-notch rows (148, 183) hold data in memory and B1 reads them as 0.0,
``zero_rows``, where the checkout has it), ``b1`` (B1 on the re-notched
RDM) and, at G2 and the sweep, ``unfused`` (the re-notch as a product,
then B1).  The mesh blocks take the width the checkout's
``halo_exchange`` gives them (widened to whole 16 bytes a row where it
takes ``pad``), their centres held bit for bit to B1 on the whole RDM;
every other form is held bit for bit to the plain version.  Each form's
times, beside ``nvidia-smi``'s name and power limit:

* ``device``: a CUDA graph of 20 calls (``chip_smoke.graph_ms``), so no
  host time of the wrapper is in it;
* ``call``: CUDA events around each call, calls in turns (median);
* ``enqueue``: the host clock over 50 calls without a synchronisation.

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
CUTS = {   # name -> (source text, its replacement), ... in csrc/cfar.cu
    "IEEE division": (("    return div5(x);", "    return __fdiv_rn(x, rf);"),),
    "no flag stores": (("        store_flags(a.flags, o, fb);\n"
                        "        store_flags(a.vflags, o, vb);\n", ""),
                       ("        a.flags[o_next] = a.range_detect ? s_fo[k * kNarrowTx + tx] : vf[k];\n"
                        "        a.vflags[o_next] = vf[k];\n", "")),
    "a box a row": (("const bool whole = SW <= kBox", "const bool whole = false && SW <= kBox"),),
    "exit at once": (("  const int band = blockIdx.x % a.n_bands;",
                      "  if (a.n_seg > 0) return;\n  const int band = blockIdx.x % a.n_bands;"),
                     ("  int s = 0;\n  while (s + 1 < a.n_seg",
                      "  if (a.n_seg > 0) return;\n  int s = 0;\n  while (s + 1 < a.n_seg")),
    "8 rows ahead": (("constexpr int kPrefetch = 4;", "constexpr int kPrefetch = 8;"),),
}
CUT_PREFETCH = {"8 rows ahead": 8}   # the plan's mirror of the ring


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


def equal(got, want) -> bool:
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


class Shape:
    """One shape: its timed forms (name -> callable), the form the port runs
    (``main``), the reference that each form's flags (``view`` of its
    output) are held to, the bound of each form in ms, and what ``--plans``
    needs to rebuild a plan (cropped rows, columns)."""

    def __init__(self, name, shape, forms, main, want, bound_ms, nvu, nr, extra=None,
                 view=None):
        self.name, self.shape, self.forms, self.main = name, shape, forms, main
        self.want, self.bound_ms, self.nvu, self.nr = want, bound_ms, nvu, nr
        self.extra = extra or {}
        self.view = view or (lambda out: out)

    def ok(self, out) -> bool:
        return equal(self.view(out), self.want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cuts", action="store_true", help="time cfar.cu with parts changed")
    ap.add_argument("--plans", action="store_true", help="time other tiles and bands")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_b1: no GPU (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    sys.path.append(str(REPO))  # chip_smoke's timers and RDMs; the package comes from --root
    import chip_smoke
    from radar_signal_process_tpu_torch.kernels import cfar as kcfar

    line = smi()
    print(line)
    fused = "zero_rows" in inspect.signature(kcfar.cascaded_cfar2d).parameters
    result = {"root": args.root, "cfar_py": kcfar.__file__, "smi": line, "fused": fused,
              "shapes": {}}
    one = torch.zeros(1, device="cuda")
    result["launch_floor_ms"] = chip_smoke.graph_ms(lambda: one.add_(1.0))
    print(f"launch floor (one 1-element PyTorch kernel in a CUDA graph of 20): "
          f"{result['launch_floor_ms']:.4f} ms | {line}")
    shapes = build_shapes(kcfar, fused, np.random.default_rng(SEED))
    for s in shapes.values():
        ok = {k: s.ok(fn()) for k, fn in s.forms.items()}
        fns = dict(s.forms)
        if "plain" in s.extra:
            fns["plain"] = s.extra["plain"]
        row = {"shape": s.shape, "main": s.main, "bit_identical": ok,
               "flags": int(s.want[0].sum()),
               "call_ms": chip_smoke.cuda_ms(fns, args.reps),
               "device_ms": {k: chip_smoke.graph_ms(fn) for k, fn in s.forms.items()},
               "enqueue_ms": {k: enqueue_ms(fn) for k, fn in s.forms.items()},
               "bound_ms": s.bound_ms}
        row["share_of_bound"] = {k: s.bound_ms[k] / ms for k, ms in row["device_ms"].items()
                                 if k in s.bound_ms}
        for k, fns_k in s.extra.get("alone", {}).items():   # each mesh block alone
            row.setdefault("alone_device_ms", {})[k] = [chip_smoke.graph_ms(f) for f in fns_k]
        if "range_off" in s.extra:
            row["range_pass_off_device_ms"] = chip_smoke.graph_ms(s.extra["range_off"])
        result["shapes"][s.name] = row
        print(f"B1 {s.name} {tuple(s.shape)}: main form {s.main}, device ms "
              f"{_fmt(row['device_ms'])}, call ms {_fmt(row['call_ms'])}, enqueue ms "
              f"{_fmt(row['enqueue_ms'])}, bound ms {_fmt(row['bound_ms'])}, share "
              f"{_fmt(row['share_of_bound'])}, bit-identical {ok}, flags {row['flags']}"
              + (f", each block alone {row['alone_device_ms']}" if "alone_device_ms" in row
                 else "")
              + (f", range pass off {row['range_pass_off_device_ms']:.4f}"
                 if "range_pass_off_device_ms" in row else "") + f" | {line}")
    if args.plans and fused:
        result["plans_ms"] = {
            s.name: _plans(kcfar, s, chip_smoke.graph_ms, VARIANTS[s.name])
            for s in shapes.values()}
    if args.cuts and fused:
        result["cuts_ms"] = _cuts(kcfar, {n: shapes[n].forms[shapes[n].main] for n in CUT_SHAPES},
                                  {n: shapes[n].extra["range_off"] for n in CUT_SHAPES},
                                  chip_smoke.graph_ms)
    print(smi())
    text = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text)
    return 0


def _fmt(d: dict) -> str:
    return "{" + ", ".join(f"{k}: {v:.4f}" for k, v in d.items()) + "}"


def build_shapes(kcfar, fused: bool, rng, dev=torch.device("cuda")) -> dict:
    """The six shapes of the module docstring, their inputs on ``dev``."""
    import chip_smoke
    from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE
    from radar_signal_process_tpu_torch.kernels import cost_model
    from radar_signal_process_tpu_torch.ops import cfar as tcfar

    segs2, cfg2, cfg0 = G2_PROFILE.cfar_segments, G2_PROFILE.cfar, G0_PROFILE.cfar
    notch_arg = "notched_rows" in inspect.signature(cost_model.cascaded_cfar_cost).parameters
    n_notched = ZERO_ROWS[1] - ZERO_ROWS[0]

    def bound(batch, nv, nr, n_clutter, cfg, notched=0) -> float:
        kw = {"notched_rows": notched} if notched and notch_arg else {}
        return cost_model.cascaded_cfar_cost(batch, nv, nr, n_clutter, cfg, **kw)["sol_s"] * 1e3

    def run_fused(x, segs):
        return lambda: kcfar.cascaded_cfar2d(x, cfg2, G2_CLUTTER, segs, zero_rows=ZERO_ROWS)

    def run_b1(x, segs, cfg=cfg2):
        return lambda: kcfar.cascaded_cfar2d(x, cfg, G2_CLUTTER, segs)

    shapes = {}
    nvu2 = G2_SHAPE[1] - 2 * G2_CLUTTER - 1
    keep = torch.ones(G2_SHAPE[1], device=dev)
    keep[ZERO_ROWS[0] : ZERO_ROWS[1]] = 0.0
    for name, batch in (("g2", G2_SHAPE[0]), ("sweep", SWEEP_BATCH)):
        x = torch.from_numpy(chip_smoke.crafted_rdm(
            (batch,) + G2_SHAPE[1:], rng, G2_CLUTTER, segs2)).to(dev)
        # the re-notch rows hold data in memory; the CFAR stage zeroes them
        x[:, ZERO_ROWS[0] : ZERO_ROWS[1]] = x[:, 20 : 20 + n_notched]
        xn = x * keep[:, None]
        forms = {"b1": run_b1(xn, segs2),
                 "unfused": lambda x=x: kcfar.cascaded_cfar2d(x * keep[:, None], cfg2,
                                                              G2_CLUTTER, segs2)}
        if fused:
            forms["fused"] = run_fused(x, segs2)
        b = {"b1": bound(batch, *G2_SHAPE[1:], G2_CLUTTER, cfg2)}
        if fused:
            b["fused"] = bound(batch, *G2_SHAPE[1:], G2_CLUTTER, cfg2, n_notched)
        shapes[name] = Shape(
            name, [batch, *G2_SHAPE[1:]], forms, "fused" if fused else "b1",
            tcfar.segmented_cfar(xn, segs2, cfg2, G2_CLUTTER), b, nvu2, G2_SHAPE[2],
            {"plain": lambda xn=xn: tcfar.segmented_cfar(xn, segs2, cfg2, G2_CLUTTER),
             "range_off": _range_off(kcfar, x if fused else xn, segs2, cfg2,
                                     ZERO_ROWS if fused else None)})
        if name == "g2":
            for sp in (2, 4):
                shapes[f"mesh_sp{sp}"] = _mesh_shape(kcfar, x, xn, sp, segs2, cfg2, fused,
                                                     bound, n_notched)
    for nr in (62, 512):
        x = torch.from_numpy(chip_smoke.crafted_rdm(
            (1, 2048, nr), rng, G0_CLUTTER, ((0, nr),), unshifted=True)[0]).to(dev)
        forms = {"b1": lambda x=x: kcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER)}
        shapes[f"g0_{nr}"] = Shape(
            f"g0_{nr}", [2048, nr], forms, "b1", tcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER),
            {"b1": bound(1, 2048, nr, G0_CLUTTER, cfg0)}, 2048 - 2 * G0_CLUTTER - 1, nr,
            {"plain": lambda x=x: tcfar.cascaded_cfar2d(x, cfg0, G0_CLUTTER),
             "range_off": _range_off(kcfar, x, ((0, nr),), cfg0, None, G0_CLUTTER)})
    return shapes


def _range_off(kcfar, x, segs, cfg, zero_rows, n_clutter=G2_CLUTTER):
    off = dataclasses.replace(cfg, range_detect=False)
    if zero_rows is None:
        return lambda: kcfar.cascaded_cfar2d(x, off, n_clutter, segs)
    return lambda: kcfar.cascaded_cfar2d(x, off, n_clutter, segs, zero_rows=zero_rows)


def _mesh_shape(kcfar, x, xn, sp: int, segs, cfg, fused: bool, bound, n_notched: int) -> Shape:
    """The halo-extended blocks of ``sp`` range shards of the G2 window, as
    ``parallel.sharding.sharded_cascaded_cfar2d`` of the checkout forms
    them: its width (widened where ``halo_exchange`` takes ``pad``), the
    table's last segment taking the columns past, and, where the checkout
    fuses the re-notch, ``zero_rows`` in place of the product."""
    from radar_signal_process_tpu_torch.parallel import sharding

    nr = x.shape[-1]
    h = cfg.ref_cells + cfg.guard_cells + 2 * cfg.range_extend_cells
    local = nr // sp
    widen = "pad" in inspect.signature(sharding.halo_exchange).parameters
    w = local + 2 * h + (-(local + 2 * h) % 4 if widen else 0)

    def blocks_of(src):
        ext = torch.cat([src[..., -h:], src, src[..., : w - local - h]], dim=-1)
        out = []
        for s in range(sp):
            table = kcfar.extended_segments(nr, segs, s * local, local, h)
            out.append((ext[..., s * local : s * local + w].contiguous(),
                        table[:-1] + ((table[-1][0], w),)))
        return out

    def runs(blocks, c=cfg, zero=None):
        if zero is None:
            return [lambda b=b, t=t: kcfar.cascaded_cfar2d(b, c, G2_CLUTTER, t) for b, t in blocks]
        return [lambda b=b, t=t: kcfar.cascaded_cfar2d(b, c, G2_CLUTTER, t, zero_rows=zero)
                for b, t in blocks]

    def window(fns):
        return lambda: [f() for f in fns]

    def stitched(parts):   # the centres of every block, stitched: the window's flags
        return tuple(torch.cat([p[i][..., h : h + local] for p in parts], -1) for i in (0, 1))

    blocks_n = blocks_of(xn)
    forms = {"b1": window(runs(blocks_n))}
    b = {"b1": sp * bound(G2_SHAPE[0], G2_SHAPE[1], w, G2_CLUTTER, cfg)}
    main = "b1"
    alone = {"b1": runs(blocks_n)}
    off = runs(blocks_n, dataclasses.replace(cfg, range_detect=False))
    if fused:
        blocks_f = blocks_of(x)
        forms["fused"] = window(runs(blocks_f, zero=ZERO_ROWS))
        b["fused"] = sp * bound(G2_SHAPE[0], G2_SHAPE[1], w, G2_CLUTTER, cfg, n_notched)
        main = "fused"
        alone = {"fused": runs(blocks_f, zero=ZERO_ROWS)}
        off = runs(blocks_f, dataclasses.replace(cfg, range_detect=False), ZERO_ROWS)
    whole = kcfar.cascaded_cfar2d(xn, cfg, G2_CLUTTER, segs)
    return Shape(f"mesh_sp{sp}", [sp, G2_SHAPE[0], G2_SHAPE[1], w], forms, main,
                 whole, b, G2_SHAPE[1] - 2 * G2_CLUTTER - 1, w,
                 {"alone": alone, "range_off": window(off)}, stitched)


def _plans(kcfar, shape: Shape, timer, variants: dict) -> dict:
    """Device ms of B1 with other plans than ``cfar_plan``'s (``variants``:
    name -> the plan's fields to override: ``sw``, the tile width, 0 for
    the narrow body where the checkout has one; ``band_rows``; ``tma``), in
    three rounds of turns, each held bit for bit to the plan's flags."""
    real = kcfar._launch_table
    run, nvu, nr, label = shape.forms[shape.main], shape.nvu, shape.nr, shape.name

    def table(over):
        def fn(*key):
            plan, tab = real(*key)
            if hasattr(kcfar, "plan_for"):   # sw 0: the narrow body
                from radar_signal_process_tpu_torch.config import CFARConfig

                cfg = CFARConfig(ref_cells=key[3], guard_cells=key[4],
                                 range_extend_cells=key[5], method=key[6])
                sw = over.get("sw", 0 if plan.narrow else plan.sw)
                tma = over.get("tma", key[8] and nr % 4 == 0)
                return kcfar.plan_for(key[0], key[1], cfg, sw,
                                      over.get("band_rows", plan.band_rows), tma), tab
            plan = plan._replace(**over)
            tx = plan.sw - 2 * plan.halo
            n_strips, n_bands = -(-nr // tx), -(-nvu // plan.band_rows)
            new = dict(tx=tx, threads=plan.sw // kcfar.COLS, n_strips=n_strips, n_bands=n_bands,
                       n_blocks=n_strips * n_bands, smem=kcfar.smem_bytes(plan.sw, key[3], key[4]))
            return plan._replace(**new), tab
        return fn

    times: dict = {}
    try:
        for rnd in range(3):
            for name, v in {"plan": None, **variants}.items():
                kcfar._launch_table = real if v is None else table(v)
                if rnd == 0:
                    if not shape.ok(run()):
                        raise RuntimeError(f"{label} plan variant {name}: flags differ")
                times.setdefault(name, []).append(timer(run))
    finally:
        kcfar._launch_table = real
    for name, t in times.items():
        print(f"B1 {label} {name}: device ms " + " ".join(f"{x:.4f}" for x in t))
    return times


_G2_V = {"tiles of 128": {"sw": 128}, "tiles of 512": {"sw": 512},
         "bands of 303": {"band_rows": 303}, "bands of 152": {"band_rows": 152},
         "bands of 76": {"band_rows": 76}, "cp.async staging": {"tma": False}}
_SWEEP_V = {"tiles of 128": {"sw": 128}, "tiles of 512": {"sw": 512},
            **{f"bands of {b}": {"band_rows": b} for b in (34, 76, 152)}}
_MESH_V = {"tiles of 128": {"sw": 128},
           **{f"bands of {b}": {"band_rows": b} for b in (303, 152, 101, 76, 61, 38)}}
_G0S_V = {**{f"bands of {b}": {"band_rows": b} for b in (2, 4, 7, 8, 12, 16)},
          **{f"tiles of 128, bands of {b}": {"sw": 128, "band_rows": b} for b in (4, 8)},
          "tiles of 128, cp.async, bands of 4": {"sw": 128, "band_rows": 4, "tma": False}}
_G0L_V = {"tiles of 256": {"sw": 256},
          **{f"bands of {b}": {"band_rows": b} for b in (4, 8, 12, 13, 16, 32)},
          **{f"narrow, bands of {b}": {"sw": 0, "band_rows": b} for b in (8, 12, 16)},
          "cp.async staging": {"tma": False}}
VARIANTS = {"g2": _G2_V, "sweep": _SWEEP_V, "mesh_sp2": _MESH_V, "mesh_sp4": _MESH_V,
            "g0_62": _G0S_V, "g0_512": _G0L_V}
CUT_SHAPES = ("g2", "g0_62", "g0_512", "mesh_sp4")


def _cuts(kcfar, runs: dict, range_off: dict, timer) -> dict:
    """Device ms of B1's main form at each shape of ``runs`` built with
    each of CUTS beside the unchanged source, and with the range pass off
    (``range_off``), in three rounds of turns."""
    from radar_signal_process_tpu_torch.kernels import _build

    src = (_build.CSRC / "cfar.cu").read_text()
    csrc, build_dir, lib0 = _build.CSRC, _build.BUILD_DIR, _build._lib
    prefetch0 = kcfar.PREFETCH

    def use(lib, name="unchanged"):  # a library, and the plan's mirror of its ring
        kcfar.PREFETCH = CUT_PREFETCH.get(name, prefetch0)
        kcfar._launch_table.cache_clear()
        _build._lib = lib

    cuts = {k: v for k, v in CUTS.items() if all(old in src for old, _ in v)}
    times: dict = {}
    with tempfile.TemporaryDirectory(prefix="bench_b1_") as tmp:
        libs = {}
        for name, edits in {"unchanged": (), **cuts}.items():
            d = pathlib.Path(tmp) / name.replace(" ", "_").replace(".", "")
            shutil.copytree(csrc, d)
            text = src
            for old, new in edits:
                text = text.replace(old, new)
            (d / "cfar.cu").write_text(text)
            _build.CSRC, _build.BUILD_DIR, _build._lib = d, d / "_build", None
            libs[name] = _build.library()
        try:
            for _ in range(3):
                for name, lib in libs.items():
                    use(lib, name)
                    for shape, run in runs.items():
                        times.setdefault(shape, {}).setdefault(name, []).append(timer(run))
                use(libs["unchanged"])
                for shape, run in range_off.items():
                    times[shape].setdefault("range pass off", []).append(timer(run))
        finally:
            use(lib0)
            _build.CSRC, _build.BUILD_DIR = csrc, build_dir
    for shape, by_cut in times.items():
        for name, t in by_cut.items():
            print(f"B1 {shape} cut {name}: device ms " + " ".join(f"{x:.4f}" for x in t))
    return times


if __name__ == "__main__":
    sys.exit(main())

"""Cut-down copies of the cells for CPU tests: the configurations' widths
and depths shrunk until a run takes seconds on a CPU, written with a
BENCHMARK.json of their own into a scratch root."""

from __future__ import annotations

import copy
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]


def tiny_configs() -> dict:
    g2 = json.loads((BENCH / "configs" / "g2.json").read_text())
    g2["scene"]["targets"]["count"] = 2
    p = g2["profile"]
    p.update(prt_per_frame=32, point_prt=1100, segment_points=[60, 240, 800],
             cfar_segments=[[0, 60], [60, 300], [300, 1100]])
    g0 = json.loads((BENCH / "configs" / "g0.json").read_text())
    g0["scene"]["targets"]["count"] = 2
    g0["profile"].update(prt_per_frame=128, point_prt=182, segment_points=[62, 120])
    g0["chain"].update(mtd_fft_length=256, pc_fft_length=128)
    return {"g2": g2, "g0": g0}


def tiny_traffic() -> dict:
    out = {}
    for name in ("ram_replay", "disk_replay"):
        t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        t.update(max_distinct=3, warmup_extra=0, keep_among=1)
        out[name] = t
    return out


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """``tmp`` holding BENCHMARK.json, the tiny configurations under
    ``configs/``, the tiny mixes under ``traffic/`` and the cells' files
    under ``cells/``."""
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "traffic").mkdir(exist_ok=True)
    (tmp / "cells").mkdir(exist_ok=True)
    for f in (BENCH / "cells").glob("*.json"):
        (tmp / "cells" / f.name).write_text(f.read_text())
    for name, cfg in tiny_configs().items():
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in tiny_traffic().items():
        (tmp / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for c in bench["configs"]:
        c["file"] = f"configs/{c['name']}.json"
    # the disk cell is not in BENCHMARK.json yet (PERF.md §7); its path is tested here
    if "g2_stream_disk" not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append({"name": "g2_stream_disk", "config": "g2",
                                   "traffic": "disk_replay", "chips": 1, "why": "tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_cell(tmp: pathlib.Path, workload: str, seed: int = 7, seconds: float = 1.0,
             capsys=None):
    """One run of ``workload`` on the CPU; returns (exit code, result line)."""
    import time

    from benchmark.harness import main

    root = make_root(tmp)
    rc = main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds)],
              time.perf_counter(), root=root, device="cpu", bench_dir=root)
    line = None
    if capsys is not None:
        out = capsys.readouterr().out.strip().splitlines()
        line = json.loads(out[-1]) if out and rc == 0 else None
    return rc, line

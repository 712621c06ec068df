"""Readings that set the limits of ``correct``: the program's numbers over
many seeds and the TF32 control's, at a cell's own size, in one process.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 --seconds 3 [--control]

Each seed: the cell's set-up, a window of ``--seconds`` at the cell's own
load, the program's check; with ``--control`` also the same numbers with
the control in the program's place.  One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import drive  # noqa: E402
from benchmark.harness import HERE, Spans, Trace, build, load_cell  # noqa: E402


def readings(workload: str, seeds, seconds: float, control: bool, root=None, device=None,
             bench_dir=None):
    import torch

    root = pathlib.Path(root or os.getcwd())
    _, _, config, traffic, system_name = load_cell(root, workload, pathlib.Path(bench_dir or HERE))
    device = torch.device(device or "cuda")
    torch.set_num_threads(config["host"]["intra_op_threads"])
    for seed in seeds:
        _, sut, source = build(config, traffic, system_name, seed, device, Spans())
        results = sut.results()
        drive.warm_up(sut, results, sut.n + traffic["warmup_extra"])
        records, kept, pulled = drive.window(sut, results, source, traffic, seed,
                                             time.perf_counter(), seconds, Trace(False, device))
        del results
        sut.release()
        checks = sut.check(kept, pulled)
        checks.update(source.store.check({k: (f, p) for k, (f, _, p) in kept.items()}))
        out = {"workload": workload, "seed": seed, "steps": len(records),
               "program": {k: v for k, (v, _) in checks.items()}}
        if control:
            out["control"] = {k: v for k, (v, _) in sut.control(kept, pulled).items()}
        source.store.close()
        del sut, source
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    for line in readings(args.workload, args.seeds, args.seconds, args.control):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

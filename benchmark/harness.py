"""Run one cell of ``BENCHMARK.json`` and print its result line.

``python3 benchmark/run.py --workload W --seed N --seconds S --trace 0|1``
from the root of a checkout.  The cell names a configuration (a file under
``configs/``) and a traffic mix (``traffic/<name>.json``, whose ``store``
names a module under ``stores/``); ``cells/<name>.json`` names the system,
a module under ``systems/`` that drives the program; with ``--trace 1``
every per-layer metric of the cell is read by ``metrics/<name>.py``.
Nothing here knows a cell by name: a new cell, mix, store, configuration,
system or metric is new files and entries.

A run: set-up (frames from the seed, the program built, every shape warmed)
-> the window, measured for ``--seconds`` under the mix's arrival process
(``drive.py``) -> the device's peak memory -> the program's state freed ->
the check against ``reference/``.  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are also the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import pathlib
import statistics
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

from benchmark import drive

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "radar_signal_process_tpu"}
TRACE_SECONDS = 8.0   # the traced part of a --trace 1 window, from its start


class Spans:
    """The harness's own spans around each call into a layer, in memory:
    ``(name, start, end, thread)`` on the host's monotonic clock."""

    def __init__(self):
        self.items: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter(), threading.get_ident()))

    def between(self, a: float, b: float, name: str | None = None) -> list:
        return [s for s in self.items if a <= s[1] and s[2] <= b and (name is None or s[0] == name)]


def kernel_name(raw: str) -> str:
    """A device event's function name: no return type, namespace, template
    arguments or parameters (``void (anonymous namespace)::f<1>(int)`` -> ``f``)."""
    s = raw.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in ("<", "("):
        s = s.split(stop, 1)[0]
    return s.rsplit("::", 1)[-1].strip()


class Trace:
    """A ``torch.profiler`` trace of the device over the first
    TRACE_SECONDS of the window (or all of it), kept as kernel intervals in
    seconds from the window's start, with the program's counters read at
    both ends of the traced part."""

    def __init__(self, enabled: bool, device, counters=dict):
        self.enabled = enabled and device.type == "cuda"
        self.read_counters = counters
        self.prof = None
        self.t0 = self.t1 = None
        self.counters = ({}, {})
        self.kernels: list = []
        self.steps = 0

    def start(self) -> None:
        """Start the profiler (its start-up falls before the window)."""
        if not self.enabled:
            return
        import torch

        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def begin(self) -> None:
        """The window opens: a marker kernel on the device, whose end is the
        traced part's origin on the device's clock, and ``t0`` on the host's."""
        if self.running:
            import torch

            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            self.counters = (self.read_counters(), {})
            self.t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def count(self, t_done: float) -> None:
        """One step's results reached the host; stop after TRACE_SECONDS."""
        if not self.running:
            return
        self.steps += 1
        if t_done - self.t0 >= TRACE_SECONDS:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        # the traced part ends here: the profiler's own stop, and its parse
        # below, stall the loop and are no part of any reading
        self.counters = (self.counters[0], self.read_counters())
        self.prof.__exit__(None, None, None)
        span = self.t1 - self.t0
        events = [(kernel_name(e.name), e.time_range.start / 1e6, e.time_range.end / 1e6)
                  for e in self.prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        origin = max((b for name, _, b in events if name == "spin_kernel"), default=0.0)
        for name, a, b in events:
            a, b = a - origin, b - origin
            if name != "spin_kernel" and b > 0 and a < span:
                self.kernels.append((name, max(a, 0.0), min(b, span)))
        self.prof = None

    @property
    def window_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def busy(self) -> list:
        """The union of the device intervals, sorted."""
        out: list = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def breakdown(self, spans: Spans) -> dict:
        """The device operations that took most time, and the device's idle
        time by the harness's spans open on the host at each gap's middle."""
        by_op: dict = {}
        for name, a, b in self.kernels:
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        gaps: dict = {}
        edge = 0.0
        for a, b in self.busy() + [[self.window_s, self.window_s]]:
            if a > edge:
                mid = self.t0 + (edge + a) / 2
                host = sorted({s[0] for s in spans.items if s[1] <= mid <= s[2]}) or ["other"]
                label = "+".join(host)
                gaps[label] = gaps.get(label, 0.0) + (a - edge)
            edge = max(edge, b)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def percentile(samples, q: float) -> float:
    """Nearest rank."""
    s = sorted(samples)
    k = max(0, min(len(s) - 1, int(-(-q * len(s) // 100)) - 1))
    return s[k]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(root: pathlib.Path, workload: str, bench_dir: pathlib.Path):
    """(BENCHMARK.json, the cell, its configuration, its mix, its system's
    name), found by the cell's name; ``bench_dir`` holds ``traffic/`` and
    ``cells/``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    system = json.loads((bench_dir / "cells" / f"{workload}.json").read_text())["system"]
    return bench, cell, config, traffic, system


def build(config: dict, traffic: dict, system_name: str, seed: int, device, spans):
    """The system under test with its frames made and its source open, not
    yet warmed: ``(system module, cell, source)``."""
    system = importlib.import_module(f"benchmark.systems.{system_name}")
    n = drive.distinct_frames(traffic, system.frame_bytes(config))
    sut = system.Cell(config, n, seed, device, spans)
    sut.make_frames(traffic["noise_std"])
    source = drive.Source(traffic, config, spans)
    source.open_store(traffic["store"], sut)
    sut.start(source)
    return system, sut, source


def forbidden_loaded() -> set:
    return {m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN


def main(argv, t_start: float, root=None, device=None, bench_dir=None) -> int:
    """``device`` None: the first card, which the cell's chip count must
    find (tests pass a CPU device and their own root and traffic)."""
    args = parse(argv)
    root = pathlib.Path(root or os.getcwd())
    bench, cell, config, traffic, system_name = load_cell(root, args.workload,
                                                          pathlib.Path(bench_dir or HERE))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.set_num_threads(config["host"]["intra_op_threads"])
    spans = Spans()
    system, sut, source = build(config, traffic, system_name, args.seed, device, spans)
    # the profiler starts before the warm-up, so that its own start-up
    # stalls nothing that the window then counts
    trace = Trace(bool(args.trace), device, sut.counters)
    trace.start()
    results = sut.results()
    drive.warm_up(sut, results, sut.n + traffic["warmup_extra"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()            # set-up's objects out of the collector's way in the window
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    records, kept, pulled = drive.window(sut, results, source, traffic, args.seed, t0,
                                         args.seconds, trace)
    t_end = t0 + args.seconds
    trace.stop()
    gc.unfreeze()
    done = [r for r in records if r[2] is not None and t0 < r[2] <= t_end]
    handed = [r for r in records if t0 <= r[1] <= t_end]
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": int(peak),
               "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    del results
    sut.release()
    checks = sut.check(kept, pulled)
    checks.update(source.store.check({k: (f, parsed) for k, (f, _, parsed) in kept.items()}))
    source.store.close()
    correct = all(v <= lim for v, lim in checks.values()) and len(done) > 0
    e2e_names = [m["name"] for m in bench["end_to_end"]
                 if "workloads" not in m or args.workload in m["workloads"]]
    lat = [(r[2] - r[1]) * 1e3 for r in done]
    e2e = {"frames_per_s": len(done) / args.seconds,
           "frame_latency_ms_p50": statistics.median(lat) if lat else float("nan"),
           "frame_latency_ms_p95": percentile(lat, 95) if lat else float("nan"),
           "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    result = {"correct": bool(correct), "attempted": len(handed),
              "failed": sum(1 for r in handed if r[2] is None)}
    if args.trace:
        ctx = SimpleNamespace(cell=cell, config=config, system=system, spans=spans, t0=t0,
                              t_end=t_end, trace=trace, records=records, seconds=args.seconds)
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, args.workload, set(e2e_names)):
                continue
            value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        if trace.window_s:
            dev["busy_s"] = sum(b - a for a, b in trace.busy())
            dev["window_s"] = trace.window_s
            result["breakdown"] = trace.breakdown(spans)
    else:
        metrics = {n: {"value": e2e[n], "unit": units[n]} for n in e2e_names}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr)
    # the last look, just before the result: nothing after the window, the
    # check and the reference included, may have loaded JAX
    loaded = forbidden_loaded()
    if loaded:
        print(f"the run loaded {sorted(loaded)}: JAX or the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0

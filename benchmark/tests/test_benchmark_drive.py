"""The traffic side on the CPU: a mix that only adds a data file (an open
loop at a fixed period) runs through the same harness; the wait shares are
taken over the traced part alone; a run that loads JAX after its window
prints no result."""

from __future__ import annotations

import json
import sys
import time
import types
from types import SimpleNamespace

from benchmark.tests.tiny import make_root


def _run(root, workload, seconds=0.8, seed=11):
    from benchmark.harness import main

    return main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds)],
                time.perf_counter(), root=root, device="cpu", bench_dir=root)


def test_a_periodic_mix_is_a_data_file(tmp_path, capsys):
    root = make_root(tmp_path)
    mix = json.loads((root / "traffic" / "ram_replay.json").read_text())
    mix["arrival"] = {"kind": "periodic", "period_s": 0.1}
    (root / "traffic" / "every_100ms.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "g0_dmx_every_100ms", "config": "g0",
                               "traffic": "every_100ms", "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "cells" / "g0_dmx_every_100ms.json").write_text(json.dumps({"system": "g0_dmx"}))
    assert _run(root, "g0_dmx_every_100ms", seconds=1.0) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    # frames due at 0, 0.1, ..., 1.0 s of the window: no more are handed over
    assert 1 <= line["attempted"] <= 11
    assert line["metrics"]["frames_per_s"]["value"] <= 11


def test_wait_shares_cover_the_traced_part_only():
    from benchmark.metrics import stream_consumer_wait_pct, stream_producer_wait_pct

    trace = SimpleNamespace(window_s=4.0, counters=(
        {"producer_wait_s": 1.0, "consumer_wait_s": 0.5},
        {"producer_wait_s": 2.0, "consumer_wait_s": 1.5}))
    ctx = SimpleNamespace(trace=trace, seconds=51.0)
    assert stream_producer_wait_pct.read(ctx) == 25.0
    assert stream_consumer_wait_pct.read(ctx) == 25.0
    ctx.trace = SimpleNamespace(window_s=None, counters=({}, {}))
    assert stream_producer_wait_pct.read(ctx) is None


def test_jax_loaded_by_the_check_means_no_result(tmp_path, capsys, monkeypatch):
    from benchmark.systems import g0_dmx

    real = g0_dmx.Cell.check

    def loading_check(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(self, *a, **k)

    monkeypatch.setattr(g0_dmx.Cell, "check", loading_check)
    rc = _run(make_root(tmp_path), "g0_dmx_ram", seconds=0.4)
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out.strip() == ""
    assert "jax" in captured.err

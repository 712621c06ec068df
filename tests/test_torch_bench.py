"""The port's bench (``radar_signal_process_tpu_torch/bench.py``) on the CPU at
cut geometry.

* its headline chain gives the JAX ``bench.build_chain``'s
  ``[sum(rdms), sum(flags)]`` on the same ``default_rng(0)`` window: the
  flag count equal, the RDM sum within f32 accumulation order (rtol 1e-4,
  as ``tests/test_bench_chain.py`` holds the JAX chains to each other);
* ``run`` prints one last JSON line with every metric, its unit, the limits
  and the device (``"cpu"``), and every check passes;
* a capture without its target makes ``main`` return non-zero, and a
  workload whose reader raises ends the run with that exception and no
  result line;
* the busy share is the union of the device intervals, and the
  percentiles are those ``bench.py`` defines.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu_torch import bench
from radar_signal_process_tpu_torch import config as tconfig
from tests.test_torch_import import as_config

torch.set_num_threads(2)

# 64 PRT keep the target's Doppler row (-5.7 m/s) outside the re-notch band
# and the clutter-cropped velocity extent above the CFAR parity floor
JTINY = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=3,
)
TINY = as_config(JTINY, tconfig)
G0 = (dataclasses.replace(tconfig.G0_PROFILE, prt_per_frame=128, point_prt=182,
                          segment_points=(62, 120)),
      dataclasses.replace(tconfig.G0ChainConfig(), pc_fft_length=128, mtd_fft_length=256))
FAST = dict(repeat=2, stream_frames=3, skip_oracle=True)
MAIN_ARGS = ["--device", "cpu", "--repeat", "2", "--stream-frames", "3", "--skip-stages",
             "--skip-oracle", "--no-trace"]


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture
def cut(monkeypatch):
    """``main`` runs the published profiles: here they are cut to TINY."""
    monkeypatch.setattr(bench, "G2_PROFILE", TINY)
    monkeypatch.setattr(bench, "G0", G0)


def test_headline_chain_matches_the_jax_bench_chain():
    shape = (TINY.n_beams, 2 * TINY.prt_per_frame, TINY.point_prt)
    host = bench.gaussian(np.random.default_rng(0), shape)
    chain, _ = bench.build_chain(TINY, torch.device("cpu"))
    got = chain(torch.from_numpy(host)).numpy()
    _, jchain = jbench.build_chain(beam_mapped=False, profile=JTINY, n_clutter=bench.N_CLUTTER)
    want = np.asarray(jax.block_until_ready(jchain(jnp.asarray(host, jnp.complex64))))
    assert got[1] == want[1] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)


def test_window_check_holds_b2_and_b1_to_their_plain_versions():
    shape = (TINY.n_beams, 2 * TINY.prt_per_frame, TINY.point_prt)
    x = torch.from_numpy(bench.gaussian(np.random.default_rng(0), shape))
    _, params = bench.build_chain(TINY, torch.device("cpu"))
    checks = bench.check_window(x, TINY, params)
    assert set(checks) == {"headline_b2", "headline_b1"}
    assert checks["headline_b2"]["ok"] and checks["headline_b2"]["peak"] > 0
    assert checks["headline_b1"] == {"flags": checks["headline_b1"]["flags"],
                                     "flags_differ": 0, "ok": True}


def test_run_prints_every_metric_on_the_last_line(capsys):
    result = bench.run("cpu", TINY, G0, **FAST)
    line = _last_json(capsys.readouterr().out)
    assert line == json.loads(json.dumps(result))
    assert line["device"] == line["kind"] == "cpu"
    assert line["metric"] == "rdm_frames_per_s_per_chip" and line["unit"] == "frames/s"
    missing = [k for k in bench.UNITS if k not in line]
    assert missing == []
    assert line["limits"] == {"g2_windows_per_s": 12.94, "g2_window_latency_ms": 77.28,
                              "g0_frames_per_s": 12.5, "g0_frame_ms": 80.0}
    assert line["ok"] and all(c["ok"] for c in line["checks"].values())
    assert set(line["checks"]) == {"headline_b2", "headline_b1", "block", "g0", "ingest",
                                   "e2e_stream_target", "e2e_stream_block_target"}
    assert line["timing_samples"] == 2 * FAST["repeat"]
    assert line["e2e_stream_windows"] == line["e2e_stream_latency_samples"] == 2
    assert set(line["stages"]) == {"read", "dbf", "pc", "mtd", "cfar", "measure"}
    for name, row in line["stages"].items():
        assert row["ms"] > 0 and {"gbytes", "gflops", "sol_ms_h100", "sol_pct"} <= set(row)
    assert line["skipped"] == ["trace", "oracle"]
    assert line["device_busy_pct"] == {"headline": None, "e2e_stream": None}
    assert line["oracle_frame_s"] is None and line["vs_baseline"] is None
    # the plain versions run on the CPU: no kernel launches
    assert all(n == 0 for c in line["launches"].values() for n in c.values())


def test_run_with_the_oracle_scales_one_beam_slice(capsys):
    result = bench.run("cpu", TINY, G0, repeat=2, skip_stages=True, skip_extras=True)
    assert result["skipped"] == ["stages", "g0", "ingest", "e2e_stream", "trace"]
    assert result["oracle_frame_s"] > 0
    assert result["vs_baseline"] == pytest.approx(
        result["oracle_frame_s"] / (result["frame_ms_p50"] / 1e3))
    assert result["ok"] and _last_json(capsys.readouterr().out)["ok"]


def test_main_exits_zero_when_every_check_passes(cut, capsys):
    assert bench.main(MAIN_ARGS) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["ok"] and line["skipped"] == ["stages", "trace", "oracle"]


def test_a_capture_without_its_target_exits_non_zero(cut, monkeypatch, capsys):
    monkeypatch.setattr(bench, "TARGET_AMPLITUDE", 0.0)
    assert bench.main(MAIN_ARGS) == 1
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert not line["ok"]
    assert not line["checks"]["e2e_stream_target"]["ok"]
    assert line["checks"]["e2e_stream_target"]["found"] == 0
    assert "e2e_stream_target" in out.err


class _BrokenReader:
    def __init__(self, *args, **kwargs):
        pass

    def read_frame(self, idx):
        raise OSError(f"frame {idx}: capture unreadable")


@pytest.mark.parametrize("workload", ["ingest", "e2e_stream"])
def test_a_workload_whose_reader_raises_ends_the_run(cut, monkeypatch, capsys, workload):
    if workload == "ingest":
        monkeypatch.setattr(bench, "g2_reader_class", lambda: _BrokenReader)
    else:
        monkeypatch.setattr(bench._StampedReader, "read_frame", _BrokenReader.read_frame)
    with pytest.raises(OSError, match="capture unreadable"):
        bench.main(MAIN_ARGS)
    assert '"ok"' not in capsys.readouterr().out


def _event(start, end, device="DeviceType.CUDA"):
    return types.SimpleNamespace(time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=device)


def test_device_busy_share_is_the_union_of_device_intervals():
    prof = types.SimpleNamespace(events=lambda: [
        _event(0, 100), _event(50, 150),           # overlap: 0-150
        _event(400, 500), _event(420, 450),        # nested: 400-500
        _event(600, 700, "DeviceType.CPU"),        # host: not counted
    ])
    assert bench.device_busy_share(prof, 1e-3) == pytest.approx(0.25)


@pytest.mark.parametrize("n", [1, 2, 7, 200])
def test_percentiles_follow_bench_py(n):
    samples = list(np.random.default_rng(n).permutation(np.arange(1.0, n + 1)))
    assert bench.p50(samples) == sorted(samples)[n // 2]
    assert bench.best3(samples) == sorted(samples)[: min(3, n)][min(3, n) // 2]
    p95 = bench.percentile(samples, 95)
    assert sum(s > p95 for s in samples) == n - int(np.ceil(0.95 * n))

"""The G1 cell at a tiny size on the CPU: the plain reference against the
port, runs that come out correct, runs with the timed path broken that come
out not correct, and a reference that loads neither JAX nor the program."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.reference.g1 import cascade, n_clutter, renotch_rows, window_rdms
from benchmark.systems.g1_stream import g1_frames, step_bound_s
from benchmark.tests.test_benchmark_imports import FORBIDDEN, _top_level
from benchmark.tests.tiny import BENCH, make_root

CPU = torch.device("cpu")
TABLE = ((0, 40, 0), (40, 113, 47), (113, 257, 200))


def tiny_g1() -> dict:
    cfg = json.loads((BENCH / "configs" / "g1.json").read_text())
    cfg["scene"]["targets"].update(count=3, amplitude=[40.0, 80.0])
    cfg["profile"].update(prt_per_frame=32, point_prt=344, segment_points=[40, 80, 224],
                          cfar_segments=[[0, 40], [40, 113], [113, 257]])
    cfg["range_concat"] = [list(e) for e in TABLE]
    cfg["host"]["intra_op_threads"] = 2      # runs beside other test workers
    return cfg


@pytest.fixture
def g1_table(monkeypatch):
    """The port's G1 table cut to the tiny geometry, as the configuration's."""
    from radar_signal_process_tpu_torch import config

    monkeypatch.setitem(config.RANGE_CONCAT, "G1", TABLE)


def _run(tmp_path, capsys, seed=5, seconds=2.0):
    import time

    from benchmark.harness import main

    root = make_root(tmp_path)
    (root / "configs" / "g1.json").write_text(json.dumps(tiny_g1()))
    rc = main(["--workload", "g1_stream_ram", "--seed", str(seed), "--seconds", str(seconds)],
              time.perf_counter(), root=root, device="cpu", bench_dir=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_window(cfg, frames):
    from benchmark.systems.g2_stream import port_profile
    from radar_signal_process_tpu_torch.config import range_concat
    from radar_signal_process_tpu_torch.models.mtd_pipeline import FrameProcessor
    from radar_signal_process_tpu_torch.params import chain_params

    prof = port_profile(cfg)
    proc = FrameProcessor(prof, chain_params(prof, device=CPU), cfg["stream"]["win_size"],
                          range_concat(prof))
    return proc(torch.as_tensor(frames[0]), torch.as_tensor(frames[1]))


def test_g1_rdms_match_the_port_and_the_control_is_farther(g1_table):
    cfg = tiny_g1()
    frames, _ = g1_frames(cfg, 2, 100.0, 9, CPU)
    ref = window_rdms(frames[0], frames[1], cfg, CPU)
    got = _port_window(cfg, frames)
    assert got.shape == ref.shape == (2, 4, 32, 257)
    port_err = float((got.double() - ref).abs().max() / ref.max())
    assert port_err < 1e-5
    ctrl = window_rdms(frames[0], frames[1], cfg, CPU, "tf32")
    assert float((ctrl.double() - ref).abs().max() / ref.max()) > 30 * port_err
    assert int(cascade(got, cfg)[0].sum()) > 0


def test_g1_step_bounds():
    """The full G1 window: B2 over 2 beams x 4 slices of 1536 x 868, B1 over
    the 8 RDMs with the /20 re-notch's rows left unread."""
    from benchmark.cost.work import bound_s, cascaded_cfar, rdm_former

    cfg = json.loads((BENCH / "configs" / "g1.json").read_text())
    assert n_clutter(cfg) == 18 and renotch_rows(cfg) == (690, 845)
    assert step_bound_s(cfg, "b2") == bound_s(*rdm_former(2, 1536, 868, [0, 384, 768, 1152]))
    assert step_bound_s(cfg, "b1") == bound_s(*cascaded_cfar(8, 1536, 868, 18, 155))
    assert step_bound_s(cfg, "b3") is None


def test_sound_run_is_correct(tmp_path, capsys, g1_table):
    line = _run(tmp_path, capsys, seed=2 ** 31 + 3)
    assert line["correct"] is True, line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"frames_per_s", "frame_latency_ms_p50",
                                    "frame_latency_ms_p95", "setup_s"}
    assert line["checks"]["flags_differ"]["value"] == 0


def _flip_one_flag(fn):
    def broken(*a, **k):
        flags, vflags = fn(*a, **k)
        flags = flags.clone()
        flags.view(-1)[flags.numel() // 2] ^= True
        return flags, vflags
    return broken


def _drop_right_beam(fn):
    """The right beam never staged: its block left as zeros."""
    def broken(self, res):
        host = fn(self, res)
        host[..., 1] = 0
        return host
    return broken


def test_flipped_flag_is_not_correct(tmp_path, capsys, monkeypatch, g1_table):
    import radar_signal_process_tpu_torch.models.detect as detect

    monkeypatch.setattr(detect, "_cascade", _flip_one_flag(detect._cascade))
    line = _run(tmp_path, capsys)
    assert line["correct"] is False and line["checks"]["flags_differ"]["value"] > 0


def test_wrong_concat_offset_is_not_correct(tmp_path, capsys, monkeypatch, g1_table):
    from radar_signal_process_tpu_torch import config

    shifted = TABLE[:2] + ((113, 257, 199),)
    monkeypatch.setitem(config.RANGE_CONCAT, "G1", shifted)
    line = _run(tmp_path, capsys)
    assert line["correct"] is False
    assert line["checks"]["rdm_err"]["value"] > line["checks"]["rdm_err"]["limit"]


def test_dropped_beam_is_not_correct(tmp_path, capsys, monkeypatch, g1_table):
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline

    monkeypatch.setattr(StreamingPipeline, "_pin", _drop_right_beam(StreamingPipeline._pin))
    line = _run(tmp_path, capsys)
    assert line["correct"] is False
    assert line["checks"]["rdm_err"]["value"] > line["checks"]["rdm_err"]["limit"]


def test_g1_reference_imports_neither_jax_nor_the_program():
    names = _top_level("import benchmark.reference.g1")
    assert not names & FORBIDDEN
    assert "radar_signal_process_tpu_torch" not in names


def test_g1_run_imports_no_jax():
    body = """
import json
from radar_signal_process_tpu_torch import config
from benchmark.tests.test_benchmark_g1 import TABLE, tiny_g1
from benchmark.tests.tiny import make_root
from benchmark.harness import main
config.RANGE_CONCAT["G1"] = TABLE
with tempfile.TemporaryDirectory() as d:
    root = make_root(pathlib.Path(d))
    (root / "configs" / "g1.json").write_text(json.dumps(tiny_g1()))
    assert main(["--workload", "g1_stream_ram", "--seed", "1", "--seconds", "0.5"],
                time.perf_counter(), root=root, device="cpu", bench_dir=root) == 0
import benchmark.metrics.g1_b1_roofline_pct, benchmark.metrics.g1_b2_roofline_pct
import benchmark.metrics.g1_host_launch_ms
"""
    names = _top_level(body)
    assert "radar_signal_process_tpu_torch" in names
    assert not names & FORBIDDEN


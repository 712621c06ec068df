"""Runs of the tiny cells on the CPU, past the harness's look for a card:
sound, they come out correct; with the timed path broken underneath, they
come out not correct."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.tiny import run_cell


def _run(tmp_path, capsys, workload, seed=5):
    rc, line = run_cell(tmp_path, workload, seed=seed, seconds=0.6, capsys=capsys)
    assert rc == 0
    return line


@pytest.mark.parametrize("workload", ["g2_stream_ram", "g2_stream_disk", "g0_dmx_ram"])
def test_sound_run_is_correct(tmp_path, capsys, workload):
    line = _run(tmp_path, capsys, workload, seed=2 ** 31 + 3)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"frames_per_s", "frame_latency_ms_p50",
                                    "frame_latency_ms_p95", "setup_s"}


def _flip_one_flag(fn):
    def broken(*a, **k):
        flags, vflags = fn(*a, **k)
        flags = flags.clone()
        flags.view(-1)[flags.numel() // 2] ^= True
        return flags, vflags
    return broken


def _half_batch(fn):
    """Half of the beams left out: their RDMs never formed."""
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    return broken


FAULTS = {
    # an answer altered where it is produced: one CFAR flag
    ("g2_stream_ram", "flag"): ("radar_signal_process_tpu_torch.models.detect", "_cascade",
                                _flip_one_flag),
    ("g2_stream_disk", "flag"): ("radar_signal_process_tpu_torch.models.detect", "_cascade",
                                 _flip_one_flag),
    ("g0_dmx_ram", "flag"): ("radar_signal_process_tpu_torch.models.g0_chain",
                             "cascaded_cfar2d", _flip_one_flag),
    # half of the batch left out
    ("g2_stream_ram", "half"): ("radar_signal_process_tpu_torch.models.mtd_pipeline",
                                "_form_rdm", _half_batch),
    ("g2_stream_disk", "half"): ("radar_signal_process_tpu_torch.models.mtd_pipeline",
                                 "_form_rdm", _half_batch),
    ("g0_dmx_ram", "half"): ("radar_signal_process_tpu_torch.models.g0_chain",
                             "fused_pc_rdm", _half_batch),
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_broken_run_is_not_correct(tmp_path, capsys, monkeypatch, workload, fault):
    import importlib

    module, name, wrap = FAULTS[(workload, fault)]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    line = _run(tmp_path, capsys, workload)
    assert line["correct"] is False


def test_altered_measurement_is_not_correct(tmp_path, capsys, monkeypatch):
    import radar_signal_process_tpu_torch.models.g0_chain as g0

    real = g0.motion_parameters

    def broken(*a, **k):
        m = real(*a, **k)
        return m._replace(elevation_deg=m.elevation_deg + 1e-3)

    monkeypatch.setattr(g0, "motion_parameters", broken)
    line = _run(tmp_path, capsys, "g0_dmx_ram")
    assert line["correct"] is False
    assert line["checks"]["measurements_differ"]["value"] > 0


def test_altered_parse_is_not_correct(tmp_path, capsys, monkeypatch):
    import radar_signal_process_tpu_torch.ingest as ingest

    real = ingest.g2_reader_class

    def broken_class(*a, **k):
        cls = real(*a, **k)

        class Broken(cls):
            def read_frame(self, idx):
                res = super().read_frame(idx)
                res.iq[0, 0, 0] += 1
                return res
        return Broken

    monkeypatch.setattr(ingest, "g2_reader_class", broken_class)
    line = _run(tmp_path, capsys, "g2_stream_disk")
    assert line["correct"] is False
    assert line["checks"]["parsed_differ"]["value"] > 0


def test_no_card_no_result(tmp_path, capsys, monkeypatch):
    """Without a card the run exits non-zero and prints no result."""
    import time

    from benchmark.harness import main
    from benchmark.tests.tiny import make_root

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = make_root(tmp_path)
    rc = main(["--workload", "g0_dmx_ram", "--seed", "1", "--seconds", "1"],
              time.perf_counter(), root=root, bench_dir=root)
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""

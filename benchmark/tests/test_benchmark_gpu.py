"""On the card: the TF32 control fails ``rdm_err`` where the program passes,
at the tiny configurations (the full-size readings are in PERF.md)."""

import json
import pathlib

import pytest
import torch

from benchmark.control import readings
from benchmark.tests.tiny import make_root

LIMITS = {n: json.loads((pathlib.Path(__file__).resolve().parents[1] / "configs"
                          / f"{n}.json").read_text())["correct_limits"] for n in ("g2", "g0")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload,config", [("g2_stream_ram", "g2"), ("g0_dmx_ram", "g0"),
                                             ("g2_stream_disk", "g2")])
def test_control_fails_where_the_program_passes(tmp_path, card, workload, config):
    root = make_root(tmp_path)
    for r in readings(workload, [1, 2, 2 ** 31 + 7], 1.0, True, root=root, device=card,
                      bench_dir=root):
        lim = LIMITS[config]["rdm_err"]
        assert r["program"]["rdm_err"] <= lim < r["control"]["rdm_err"]
        assert all(v == 0 for k, v in r["program"].items() if k != "rdm_err")

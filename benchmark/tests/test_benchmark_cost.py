"""The frozen work counts against hand arithmetic at the cells' shapes."""

import json
import math
import pathlib

import pytest

from benchmark.cost.work import PEAKS, bound_s, cascaded_cfar, fused_pc_rdm, rdm_former
from benchmark.systems import g0_dmx, g2_stream

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"


def test_rdm_former_at_g2():
    n_bytes, ops = rdm_former(13, 332, 3404, [0, 83, 166, 249])
    # rows 0..580 of the 664-row window, the window, 52 RDMs out
    assert n_bytes == 13 * 581 * 3404 * 8 + 332 * 4 + 52 * 332 * 3404 * 4
    fft = 5 * 332 * math.log2(332)
    assert ops == pytest.approx(52 * 3404 * (2 * 332 + fft + 4 * 332))
    assert bound_s(n_bytes, ops) == pytest.approx(n_bytes / 3.35e12)


def test_cascaded_cfar_at_g2_and_g0():
    # G2: 52 RDMs, 14 clutter rows, the re-notch's 35 rows unread
    n_bytes, ops = cascaded_cfar(52, 332, 3404, 14, 35)
    assert n_bytes == 52 * (303 - 35) * 3404 * 4 + 2 * 52 * 332 * 3404
    assert ops == 18 * 52 * 303 * 3404
    # G0 short and long pulse RDMs, 6 clutter rows
    assert cascaded_cfar(1, 2048, 62, 6)[0] == 2035 * 62 * 4 + 2 * 2048 * 62
    assert cascaded_cfar(1, 2048, 512, 6)[0] == 2035 * 512 * 4 + 2 * 2048 * 512
    with pytest.raises(ValueError):
        cascaded_cfar(1, 64, 8, 6, 60)


def test_fused_pc_rdm_at_g0():
    short = fused_pc_rdm(2, 1536, 62, 62, 2048, fir_taps=35)
    assert short[0] == 2 * 1536 * 62 * 8 + 1536 * 4 + 35 * 4 + 2 * 2048 * 62 * 4
    fir = 4 * (sum(range(1, 36)) + 35 * (62 - 35))
    doppler = 2 * 1536 + 5 * 2048 * 11 + 4 * 2048
    assert short[1] == pytest.approx(2 * (1536 * fir + 62 * doppler))
    long_ = fused_pc_rdm(2, 1536, 504, 512, 2048, pc_fft=512)
    assert long_[0] == 2 * 1536 * 504 * 8 + 1536 * 4 + 512 * 8 + 2 * 2048 * 512 * 4
    pc = 2 * 5 * 512 * 9 + 6 * 512
    assert long_[1] == pytest.approx(2 * (1536 * pc + 512 * doppler))


def test_step_bounds_of_the_cells():
    g2 = json.loads((CONFIGS / "g2.json").read_text())
    g0 = json.loads((CONFIGS / "g0.json").read_text())
    g2_bound, g0_bound = g2_stream.step_bound_s, g0_dmx.step_bound_s
    assert g2_bound(g2, "b2") == pytest.approx(
        rdm_former(13, 332, 3404, [0, 83, 166, 249])[0] / PEAKS["hbm_bytes_per_s"])
    assert g2_bound(g2, "b1") == pytest.approx(
        cascaded_cfar(52, 332, 3404, 14, 35)[0] / PEAKS["hbm_bytes_per_s"])
    assert g2_bound(g2, "b3") is None and g0_bound(g0, "b2") is None
    assert g0_bound(g0, "b1") == pytest.approx(
        (cascaded_cfar(1, 2048, 62, 6)[0] + cascaded_cfar(1, 2048, 512, 6)[0]) / 3.35e12)
    assert g0_bound(g0, "b3") == pytest.approx(
        (fused_pc_rdm(2, 1536, 62, 62, 2048, fir_taps=35)[0]
         + fused_pc_rdm(2, 1536, 504, 512, 2048, pc_fft=512)[0]) / 3.35e12)

"""The port's H100 cost model (``kernels/cost_model.py``) against the bounds
``PERF.md`` §6 reports and against the JAX model's collective bytes."""

import pytest

from radar_signal_process_tpu.config import CFARConfig as JCFARConfig
from radar_signal_process_tpu.config import G2_PROFILE as JG2
from radar_signal_process_tpu.kernels import cost_model as jcost
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, CFARConfig
from radar_signal_process_tpu_torch.kernels import cost_model as cost
from radar_signal_process_tpu_torch.models.detect import clutter_cells


def test_b1_bound_at_g2_and_the_sweep_batch():
    """B1 over a G2 window: 332.1 MB, 0.0991 ms, bound by bytes; at the
    sweep's batch of 4: 25.5 MB, 0.0076 ms."""
    n_clutter = clutter_cells(G2_PROFILE, 332)
    c = cost.cascaded_cfar_cost(52, 332, 3404, n_clutter, G2_PROFILE.cfar)
    assert n_clutter == 14 and c["bound_by"] == "bytes"
    assert round(c["hbm_bytes"] / 1e6, 1) == 332.1
    assert round(c["sol_s"] * 1e3, 4) == 0.0991
    s = cost.cascaded_cfar_cost(4, 332, 3404, n_clutter, G2_PROFILE.cfar)
    assert round(s["hbm_bytes"] / 1e6, 1) == 25.5 and round(s["sol_s"] * 1e3, 4) == 0.0076
    assert cost.g2_frame_fused_cfar_projection()["hbm_bytes"] == c["hbm_bytes"]


def test_b1_bound_with_the_fused_renotch():
    """With the re-notch fused into B1 the 35 notched rows of a G2 window
    (148-182, ``models.detect.renotch_rows``) are not read: 307.3 MB,
    0.0917 ms; at the sweep's batch 23.6 MB.  A count outside the used rows
    raises."""
    cfg = G2_PROFILE.cfar
    c = cost.cascaded_cfar_cost(52, 332, 3404, 14, cfg, notched_rows=35)
    full = cost.cascaded_cfar_cost(52, 332, 3404, 14, cfg)
    assert full["hbm_bytes"] - c["hbm_bytes"] == 52 * 35 * 3404 * 4
    assert round(c["hbm_bytes"] / 1e6, 1) == 307.3 and round(c["sol_s"] * 1e3, 4) == 0.0917
    s = cost.cascaded_cfar_cost(4, 332, 3404, 14, cfg, notched_rows=35)
    assert round(s["hbm_bytes"] / 1e6, 1) == 23.6 and c["bound_by"] == "bytes"
    for bad in (-1, 304):
        with pytest.raises(ValueError, match="notched rows"):
            cost.cascaded_cfar_cost(52, 332, 3404, 14, cfg, notched_rows=bad)


def test_b1_bound_at_g0():
    """B1 over G0's two segments (2048 x 62 and 2048 x 512, n_clutter 6):
    0.00023 and 0.0019 ms."""
    g0 = [cost.cascaded_cfar_cost(1, 2048, n_r, 6, CFARConfig()) for n_r in (62, 512)]
    assert round(g0[0]["sol_s"] * 1e3, 5) == 0.00023 and round(g0[1]["sol_s"] * 1e3, 4) == 0.0019


@pytest.mark.parametrize("shape, want_ms", [
    ((52, 332, 3404, None), 0.946),      # G2 window
    ((2, 1536, 868, None), 0.199),       # G1 validation chain
    ((4, 332, 3404, None), 0.073),       # the sweep's batch
], ids=["g2", "g1", "sweep"])
def test_b2_bound(shape, want_ms):
    """B2 is bound by its operations at the 3xTF32 rate."""
    c = cost.rdm_former_cost(*shape)
    assert c["bound_by"] == "operations"
    assert round(c["sol_s"] * 1e3, 3) == want_ms
    batch, n, n_r, _ = shape
    assert c["flops"] == 3 * 8.0 * n * n * batch * n_r


def test_b3_bound_at_g0():
    """B3 over one G0 frame, both pulse segments (62 -> 62 and 504 -> 512
    columns, 1536 PRT, 2048-point DFT): 0.214 ms."""
    ps = G0_PROFILE.segment_points[0]
    segs = [cost.fused_pc_rdm_cost(2, 1536, n_in, n_out, 2048)
            for n_in, n_out in ((ps, ps), (G0_PROFILE.point_prt - ps, 512))]
    total = cost.roofline(sum(c["hbm_bytes"] for c in segs), sum(c["flops"] for c in segs),
                          cost.H100_TF32_FLOPS)
    assert all(c["bound_by"] == "operations" for c in segs)
    assert round(total["sol_s"] * 1e3, 3) == 0.214


def test_pc_bytes_and_bound_at_g2():
    """PC over a G2 window (13 beams x 664 PRT x 3404 samples): the complex64
    echo in and out, 470.2 MB with the three filter spectra (FFT lengths 270,
    960, 3200); 0.1403 ms, bound by bytes."""
    c = cost.pulse_compression_cost(G2_PROFILE, 13 * 664, (35, 200, 700))
    assert c["hbm_bytes"] == 2 * 13 * 664 * 3404 * 8 + (270 + 960 + 3200) * 8
    assert round(c["hbm_bytes"] / 1e6, 1) == 470.2 and c["bound_by"] == "bytes"
    assert round(c["sol_s"] * 1e3, 4) == 0.1403
    assert round(c["flops"] / 1e9, 2) == 4.45


def test_dbf_bytes_and_bound_at_g2():
    """DBF of one G2 frame (332 x 3404 samples, 16 channels -> 13 beams):
    262.2 MB, 1.88 GFLOP; 0.0783 ms, bound by bytes."""
    c = cost.dbf_cost(332 * 3404, 16, 13)
    assert c["hbm_bytes"] == (332 * 3404 * 16 + 13 * 16 + 332 * 3404 * 13) * 8
    assert round(c["hbm_bytes"] / 1e6, 1) == 262.2 and c["bound_by"] == "bytes"
    assert c["flops"] == 8.0 * 332 * 3404 * 16 * 13
    assert round(c["sol_s"] * 1e3, 4) == 0.0783


def test_extraction_bytes_and_bound_at_g2():
    """The detection list of a G2 window (52 RDMs, 64 entries each): the
    flags and the RDM read once, 293.9 MB; 0.0877 ms, bound by bytes."""
    c = cost.extraction_cost(52, 332, 3404, 64)
    assert c["hbm_bytes"] == 52 * 332 * 3404 * 5 + 52 * 64 * 13
    assert round(c["hbm_bytes"] / 1e6, 1) == 293.9 and c["bound_by"] == "bytes"
    assert round(c["sol_s"] * 1e3, 4) == 0.0877


@pytest.mark.parametrize("dp, sp", [(1, 2), (2, 2), (1, 4), (4, 1)])
def test_sharded_stream_bytes_equal_the_jax_model(dp, sp):
    """Per window and card, the all-to-all and halo bytes of the JAX model;
    only the link and the compute differ (NVLink, the H100 bounds)."""
    want = jcost.sharded_stream_comm_cost(JG2, dp=dp, sp=sp, cfg=JCFARConfig(threshold=5.0))
    got = cost.sharded_stream_comm_cost(G2_PROFILE, dp=dp, sp=sp,
                                        cfg=CFARConfig(threshold=5.0))
    assert got["n_chips"] == want["n_chips"] == dp * sp
    assert got["a2a_mb_per_chip"] == want["a2a_mb_per_chip"]
    assert got["halo_mb_per_chip"] == want["halo_mb_per_chip"]
    link = cost.H100_NVLINK_BPS
    assert got["comm_ms"] == pytest.approx(
        (got["a2a_bytes_per_chip"] + got["halo_bytes_per_chip"]) / link * 1e3)
    assert 0.0 < got["efficiency_pct"] <= 100.0

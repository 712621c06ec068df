"""The plain reference against the port, at the tiny configurations on the CPU."""

from __future__ import annotations

import pytest
import torch

from benchmark.frames import g0_frames, g2_frames
from benchmark.reference import cfar as ref_cfar
from benchmark.reference import g0 as ref_g0
from benchmark.reference.g2 import window_rdms
from benchmark.systems.g2_stream import port_profile
from benchmark.tests.tiny import tiny_configs

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def g2():
    cfg = tiny_configs()["g2"]
    frames, coeffs, _ = g2_frames(cfg, 3, 100.0, 5, CPU)
    return cfg, frames, coeffs


def _port_window(cfg, frames, coeffs):
    from radar_signal_process_tpu_torch.models.mtd_pipeline import make_frame_processor
    from radar_signal_process_tpu_torch.ops.dbf import apply_dbf

    prof = port_profile(cfg)
    proc = make_frame_processor(prof, cfg["stream"]["win_size"], device="cpu")
    c = torch.as_tensor(coeffs, dtype=torch.complex64)
    beams = [apply_dbf(torch.as_tensor(f), c).permute(2, 0, 1).contiguous() for f in frames[:2]]
    return proc(*beams)


def test_g2_rdms_match_the_port(g2):
    cfg, frames, coeffs = g2
    ref = window_rdms(frames[0], frames[1], coeffs, cfg, CPU)
    got = _port_window(cfg, frames, coeffs)
    assert got.shape == ref.shape
    err = float((got.double() - ref).abs().max() / ref.max())
    assert err < 1e-5


def test_g2_tf32_control_is_farther_than_the_port(g2):
    cfg, frames, coeffs = g2
    ref = window_rdms(frames[0], frames[1], coeffs, cfg, CPU)
    ctrl = window_rdms(frames[0], frames[1], coeffs, cfg, CPU, "tf32")
    got = _port_window(cfg, frames, coeffs)
    port_err = float((got.double() - ref).abs().max() / ref.max())
    ctrl_err = float((ctrl.double() - ref).abs().max() / ref.max())
    assert ctrl_err > 30 * port_err


def test_cascade_and_detection_list_match_the_port(g2):
    from radar_signal_process_tpu_torch.kernels.cfar import cascaded_cfar2d_plain
    from radar_signal_process_tpu_torch.models.detect import clutter_cells, renotch_rows
    from radar_signal_process_tpu_torch.ops.measure import extract_detections

    cfg, frames, coeffs = g2
    prof = port_profile(cfg)
    rdms = _port_window(cfg, frames, coeffs)
    n_c = clutter_cells(prof, prof.prt_per_frame, cfg["stream"]["clutter_v"])
    zero = renotch_rows(prof, prof.prt_per_frame, n_c, cfg["stream"]["renotch_divisor"])
    assert zero == ref_cfar.renotch_zero_rows(prof.prt_per_frame, cfg["stream"]["renotch_divisor"],
                                              n_c, True)
    flags, vflags = cascaded_cfar2d_plain(rdms, prof.cfar, n_c, prof.cfar_segments, zero)
    rf, rvf = ref_cfar.cascade(rdms, cfg["profile"]["cfar"], n_c,
                               [tuple(s) for s in cfg["profile"]["cfar_segments"]], zero)
    assert torch.equal(rf, flags) and torch.equal(rvf, vflags)
    assert int(flags.sum()) > 0
    d = extract_detections(flags, rdms, cfg["stream"]["max_detections"])
    amp, cells = ref_cfar.detection_list(rf, rdms, cfg["stream"]["max_detections"])
    assert ref_cfar.detection_mismatches(d.amplitude.numpy(), d.v_idx.numpy(), d.r_idx.numpy(),
                                         amp, cells) == 0
    # one altered entry is counted
    bad = d.amplitude.numpy().copy()
    bad.reshape(-1)[0] *= 2
    assert ref_cfar.detection_mismatches(bad, d.v_idx.numpy(), d.r_idx.numpy(), amp, cells) >= 1


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_g0_frame_matches_the_port(seed):
    from radar_signal_process_tpu_torch.config import G0ChainConfig
    from radar_signal_process_tpu_torch.models.g0_chain import G0Chain

    cfg = tiny_configs()["g0"]
    left, right, fi, bp, _ = g0_frames(cfg, 3, 100.0, seed, CPU)
    chain = G0Chain(port_profile(cfg), G0ChainConfig(**cfg["chain"]),
                    max_detections=cfg["dmx"]["max_detections"], device="cpu")
    res = chain.process_frame(left[0], right[0], freq_index=int(fi[0]), beam_pos=int(bp[0]))
    scal = ref_g0.frame_scalars(cfg, int(fi[0]), int(bp[0]))
    beams = torch.stack([torch.as_tensor(left[0]), torch.as_tensor(right[0])])
    (ss, sd), (ls, ld) = ref_g0.sum_diff(*ref_g0.beam_rdms(beams, cfg), scal["n_clutter"])
    for got, want, peak in ((res.rdm_sum_short, ss, ss), (res.rdm_diff_short, sd, ss),
                            (res.rdm_sum_long, ls, ls), (res.rdm_diff_long, ld, ls)):
        assert float((got.double() - want).abs().max() / peak.max()) < 1e-5
    scales = ref_g0.range_scales(cfg)
    for s, d, det, meas, r_scale in (
            (res.rdm_sum_short, res.rdm_diff_short, res.detections_short,
             res.measurements_short, scales[0]),
            (res.rdm_sum_long, res.rdm_diff_long, res.detections_long,
             res.measurements_long, scales[1])):
        r, v, e = ref_g0.measurements(s, d, det.v_idx, det.r_idx, r_scale, scal,
                                      int(bp[0]), cfg)
        for a, b in ((r, meas.range_m), (v, meas.velocity_ms), (e, meas.elevation_deg)):
            assert torch.equal(a, b)
    assert int(res.detections_long.valid.sum()) > 0

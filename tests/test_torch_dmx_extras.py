"""``cli dmx --gps/--gps-start-line/--frames-shift/--plots/--save-results``
of the port against the JAX package's, and the port's copies of the GPS,
dataset and plotting modules.

One full-G0 capture (the known-good target of ``tests/test_cli_dmx.py``)
goes through both packages' ``dmx``, the port's with ``--device cpu``.  The
estimates of the two packages differ within the G0 slice's tolerance
(``tests/test_torch_g0.py``: one spline step of range), so the residuals
are held two ways: the port's against the JAX package's GPS functions run
on the port's own estimates (within 1e-6), and against the JAX CLI's
residuals within the estimate tolerance.  The ``.mat`` result struct has
the JAX package's variables and config echo; the plots the same names.
"""

import json
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import radar_signal_process_tpu.cli as jcli
from radar_signal_process_tpu.config import G0_PROFILE, G0ChainConfig
from radar_signal_process_tpu.evalx import gps as jgps
from radar_signal_process_tpu.models.g0_chain import G0Chain as JaxG0Chain
from radar_signal_process_tpu.utils import dataset as jdataset
from radar_signal_process_tpu.utils import save_frame as jsave_frame
from radar_signal_process_tpu_torch import cli as tcli
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch import evalx as tevalx
from radar_signal_process_tpu_torch.utils import dataset as tdataset
from tests.test_cli_dmx import _g0_capture
from tests.test_torch_import import as_config

torch.set_num_threads(2)

PROF, CFG = G0_PROFILE, G0ChainConfig()
FD = -60 * PROF.prf / CFG.mtd_fft_length
R_LONG = 100 * PROF.delta_r + CFG.r_sys_err_long - CFG.r_measure_err_long
RANGE_TOL = PROF.delta_r / 8 + 1e-3     # tests/test_torch_g0.py: one spline step


def _gps_track(path, n_header=1, n=4, r_bias=3.0):
    """A 5-column track with ``n_header`` text lines, truth + bias at every
    frame time, one invalid (zero range) row."""
    t_frame = PROF.prt * PROF.prt_per_frame
    v_true = -JaxG0Chain(PROF, CFG, 5, 2).wavelength * FD / 2.0
    lines = [f"header {i}" for i in range(n_header)]
    for i in range(n):
        r = 0.0 if i == 2 else R_LONG + r_bias + 0.5 * i
        lines.append(f"{i * t_frame:.6f} {r:.3f} {v_true + 0.01 * i:.4f} 100.0 50.0")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def dmx_runs(tmp_path_factory):
    """Both packages' ``dmx`` with every output flag, over one capture."""
    root = tmp_path_factory.mktemp("dmx")
    _g0_capture(root, np.random.default_rng(20250817), FD, 100)
    gps = _gps_track(root / "gps.txt")
    runs = {}
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        argv = ["dmx", "--input", str(root), "--frames", "1", "--freq-index", "5",
                "--beam-pos", "2", "--gps", gps, "--gps-start-line", "2",
                "--frames-shift", "1", "--plots", str(root / f"{pkg}_plots"),
                "--save-results", str(root / f"{pkg}_results")] + extra
        out = _capture_json(main, argv)
        runs[pkg] = out
    runs["gps"], runs["root"] = gps, root
    return runs


def _capture_json(main, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_dmx_outputs_have_the_jax_keys(dmx_runs):
    got, want = dmx_runs["port"], dmx_runs["jax"]
    assert sorted(got) == sorted(want) == [
        "frames", "gps_range_residuals", "gps_velocity_residuals", "plots", "result_mat"]
    assert got["frames"][0]["long"]["range_m"]


@pytest.mark.parametrize("which", ["range", "velocity"])
def test_dmx_gps_residuals(dmx_runs, which):
    """The residuals equal the JAX package's GPS functions on the port's own
    estimates within 1e-6, and the JAX CLI's within the estimate tolerance."""
    got = dmx_runs["port"][f"gps_{which}_residuals"]
    want = dmx_runs["jax"][f"gps_{which}_residuals"]
    frames = dmx_runs["port"]["frames"]
    key = "range_m" if which == "range" else "velocity_ms"
    track = jgps.read_gps_track(dmx_runs["gps"], start_line=2)
    gi = jgps.gps_frame_indices(track, PROF.prt, PROF.prt_per_frame, 1)
    track, gi = jgps.drop_invalid(track, gi)
    assert len(track.time_s) == 3 and gi[0] == 1.0
    fr = np.asarray([f["frame"] for f in frames for _ in f["long"]["range_m"]], np.float64)
    est = np.asarray([x for f in frames for x in f["long"][key]])
    ref = jgps.compare_estimates(fr, est, gi, getattr(track, key))
    assert sorted(got) == sorted(ref) == sorted(want) == ["bias", "max_abs", "n", "rmse"]
    assert got["n"] == ref["n"] == want["n"] >= 1
    for k in ("bias", "max_abs", "rmse"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
        tol = RANGE_TOL if which == "range" else 1e-3
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_dmx_gps_outside_the_track(tmp_path, capsys):
    """Frames outside the GPS span leave no residual: ``n`` 0, NaN rmse."""
    _g0_capture(tmp_path, np.random.default_rng(1), FD, 100)
    gps = _gps_track(tmp_path / "gps.txt", n_header=0)
    out = _capture_json(tcli.main, [
        "dmx", "--input", str(tmp_path), "--frames", "1", "--freq-index", "5",
        "--beam-pos", "2", "--gps", gps, "--frames-shift", "10", "--device", "cpu"])
    assert out["gps_range_residuals"]["n"] == 0
    assert out["gps_range_residuals"]["rmse"] != out["gps_range_residuals"]["rmse"]
    assert "plots" not in out and "result_mat" not in out


def test_dmx_save_results_has_the_jax_variables(dmx_runs):
    got_path, want_path = dmx_runs["port"]["result_mat"], dmx_runs["jax"]["result_mat"]
    assert os.path.basename(got_path).startswith("resultData_")
    assert os.path.dirname(got_path) == str(dmx_runs["root"] / "port_results")
    got = sio.loadmat(got_path, squeeze_me=True)
    want = sio.loadmat(want_path, squeeze_me=True)
    keys = sorted(k for k in want if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    # the config echo: every G0ChainConfig field, as the JAX package saves it
    for field in ("pc_window", "mtd_fft_length", "r_interp_times", "beam_angle_step",
                  "r_sys_err_long", "north_angle"):
        assert got[field] == want[field], field
    for k in ("frameS", "frameE", "framesProcessTotal", "freqInd", "beamPosNum",
              "freqIndSeries", "beamPosSeries", "angleCodeSeries"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert str(got["orgDataFilePath"]) == str(want["orgDataFilePath"])
    frame = dmx_runs["port"]["frames"][0]
    for name in ("short", "long"):
        est = got["resultEst_Struct"][name].item()
        assert sorted(est.dtype.names) == sorted(
            want["resultEst_Struct"][name].item().dtype.names)
        np.testing.assert_allclose(np.atleast_1d(est["rEst"].item()), frame[name]["range_m"],
                                   rtol=1e-12)
        np.testing.assert_allclose(np.atleast_1d(est["vEst"].item()),
                                   frame[name]["velocity_ms"], rtol=1e-12)


def test_dmx_plots_have_the_jax_names(dmx_runs):
    got, want = dmx_runs["port"]["plots"], dmx_runs["jax"]["plots"]
    assert sorted(got) == sorted(want) == ["long", "short"]
    for name in got:
        assert os.path.basename(got[name]) == os.path.basename(want[name]) == \
            f"estimates_{name}.png"
        assert os.path.getsize(got[name]) > 1000
    assert sorted(os.listdir(dmx_runs["root"] / "port_plots")) == sorted(
        os.listdir(dmx_runs["root"] / "jax_plots"))


# ----------------------------------------------------------------- the copies
def test_gps_functions_equal_the_jax_package(tmp_path):
    path = tmp_path / "gps.txt"
    rows = ["time range velocity az height", "1000.0, 500.0, -6.0, 120.0, 55.0", "short row"]
    rows += [f"{1000.0 + 0.5 * k} {500.0 + 10 * k if k != 4 else 0.0} -6.0 120.0 55.0"
             for k in range(1, 10)]
    path.write_text("\n".join(rows))
    for start, n_lines in ((1, None), (2, None), (3, 4)):
        got = tevalx.read_gps_track(str(path), start_line=start, n_lines=n_lines)
        want = jgps.read_gps_track(str(path), start_line=start, n_lines=n_lines)
        assert type(got).__name__ == "GPSTrack" and len(got.time_s) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        gi = tevalx.gps_frame_indices(got, 52.08e-6, 1536, frames_shift=7)
        np.testing.assert_array_equal(gi, jgps.gps_frame_indices(want, 52.08e-6, 1536, 7))
        tg, tgi = tevalx.drop_invalid(got, gi)
        jg, jgi = jgps.drop_invalid(want, gi)
        np.testing.assert_array_equal(tgi, jgi)
        est = np.linspace(490.0, 600.0, 11)
        fr = np.linspace(gi.min() - 1, gi.max() + 1, 11)
        assert tevalx.compare_estimates(fr, est, tgi, tg.range_m) == \
            jgps.compare_estimates(fr, est, jgi, jg.range_m)


def test_dataset_helpers_equal_the_jax_package(tmp_path, rng):
    tprof = as_config(PROF, tconfig)
    rdm = rng.standard_normal((2, 1536, 64))
    got, rows = tdataset.crop_velocity_band(rdm, tprof, -15.0, 12.0)
    want, wrows = jdataset.crop_velocity_band(rdm, PROF, -15.0, 12.0)
    assert rows == wrows and rows[1] > rows[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdataset.sinc2d(33, 5.0), jdataset.sinc2d(33, 5.0))
    for i in range(3):
        jsave_frame(str(tmp_path), i, {"servo_angle": np.full(4, 10.0 * i)}, PROF)
    np.testing.assert_array_equal(tdataset.extract_angle_series(str(tmp_path)),
                                  jdataset.extract_angle_series(str(tmp_path)))
    curve = tmp_path / "stc.txt"
    curve.write_text("0.0 -1.5\n-3.0\t-4.5\n  -6.0\n")
    np.testing.assert_array_equal(tdataset.load_stc_curve(str(curve), max_len=4),
                                  jdataset.load_stc_curve(str(curve), max_len=4))
    curve.write_bytes(b"1.0 \xff 2.0")
    with pytest.raises(ValueError, match="binary"):
        tdataset.load_stc_curve(str(curve))


@pytest.mark.parametrize("plot", ["rdm_image", "dashboard", "rdm_3d", "pc_magnitude",
                                  "doppler_spectrum", "iq_debug", "estimate_series"])
def test_plots_write_files(tmp_path, rng, plot):
    """Each plot of the port's ``viz`` copy writes its file."""
    from radar_signal_process_tpu_torch import viz

    tprof = as_config(PROF, tconfig)
    rdm = np.abs(rng.standard_normal((64, 128))) + 0.1
    rdm[40, 80] = 50.0
    path = str(tmp_path / f"{plot}.png")
    iq = rng.standard_normal((4, 32)) + 1j * rng.standard_normal((4, 32))
    fr = np.repeat(np.arange(5), 2).astype(float)
    call = {
        "rdm_image": lambda: viz.plot_rdm_image(rdm, tprof, save_path=path, flags=rdm > 3),
        "dashboard": lambda: viz.plot_mtd_dashboard(rdm, tprof, save_path=path),
        "rdm_3d": lambda: viz.plot_rdm_3d(rdm, tprof, save_path=path, r_lim=(0, 500)),
        "pc_magnitude": lambda: viz.plot_pc_magnitude(iq[0], 2, save_path=path),
        "doppler_spectrum": lambda: viz.plot_doppler_spectrum(rdm[:, 80], np.arange(64.0),
                                                              80, save_path=path),
        "iq_debug": lambda: viz.plot_iq_debug(iq, 2 * iq, 1, 3, save_path=path),
        "estimate_series": lambda: viz.plot_estimate_series(
            fr, 500 + fr, -6 + 0 * fr, 12 + 0 * fr, gps_frames=np.arange(5.0),
            gps_range_m=500 + np.arange(5.0), gps_velocity_ms=np.full(5, -6.0),
            save_path=path),
    }[plot]
    assert call() == path and os.path.getsize(path) > 1000
    assert viz.rdm_to_db(rdm).max() == 0.0

"""The stage CLIs of the port (``ingest`` -> ``mtd`` -> ``detect`` ->
``analyze``) and their file bus against the JAX package's.

One seeded capture at the JAX tests' TINY geometry (``tests/test_cli.py``)
goes through both packages' CLIs, the port's with ``--device cpu``, in both
artifact formats (the ``.npz`` manifests and the reference's ``.mat``
variables).  Tolerances:

* stage-1 artifacts: bit for bit (both packages store what the reader
  returns); beamformed with ``--dbf-coeffs``, within f32 rounding;
* RDMs: ``|got - want| <= 2e-5 * peak + 2e-4 * |want|`` (the slice
  tolerance: the JAX CLI's CPU path reuses PC across windows and XLA's FFT
  rounds otherwise);
* flags: bit for bit, both ``detect`` commands reading the same RDM file
  (the JAX package's); detection lists on valid entries, as sets (ROADMAP
  C4); spectral widths within 1e-5;
* cross-reads: each package reads the other's artifacts and gets equal
  arrays and an equal profile.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.io as sio
import torch

import radar_signal_process_tpu.cli as jcli
from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.utils import load_frame as jload_frame
from radar_signal_process_tpu.utils import matbus as jmatbus
from radar_signal_process_tpu_torch import cli as tcli
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.utils import load_frame as tload_frame
from radar_signal_process_tpu_torch.utils import matbus as tmatbus
from tests.test_torch_import import as_config

torch.set_num_threads(2)

TINY = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    n_channels=2, n_beams=2,
)
TG1 = dataclasses.replace(
    jconfig.G1_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)),
)
# above the CFAR parity floor on both axes (ROADMAP C3): the JAX stream's
# CPU path computes its flags in the padded form
TINYS = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(40, 80, 224),
    cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=2,
)
# more channels than beams: `e2e` runs without DBF, so its rows are channels
# (ROADMAP C11)
TINYC = dataclasses.replace(TINY, n_channels=3)
PORT = ["--device", "cpu"]
RDM_ATOL, RDM_RTOL = 2e-5, 2e-4


@pytest.fixture(scope="module", autouse=True)
def profiles():
    """Both packages' profile tables get the reduced geometries."""
    with pytest.MonkeyPatch.context() as mp:
        for name, prof in (("TINY", TINY), ("TG1", TG1), ("TINYS", TINYS), ("TINYC", TINYC)):
            mp.setitem(jconfig.PROFILES, name, prof)
            mp.setitem(tconfig.PROFILES, name, as_config(prof, tconfig))
        yield


def _assert_rdm_close(got, want):
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=RDM_RTOL, atol=RDM_ATOL * peak)


def _mat_vars(path):
    return {k: v for k, v in sio.loadmat(path).items() if not k.startswith("__")}


def _raw(path, key):
    with np.load(path) as z:
        return bytes(z[key])


def _det_cells(arrays, idx):
    valid = arrays["det_valid"][idx]
    return set(zip(arrays["det_v"][idx][valid].tolist(), arrays["det_r"][idx][valid].tolist()))


def _assert_same_detections(got, want):
    np.testing.assert_array_equal(got["flags"], want["flags"])
    np.testing.assert_array_equal(got["vflags"], want["vflags"])
    for key in ("det_v", "det_r", "det_amp", "det_valid"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
    for idx in np.ndindex(*want["det_valid"].shape[:-1]):
        assert _det_cells(got, idx) == _det_cells(want, idx), idx
        np.testing.assert_array_equal(np.sort(got["det_amp"][idx][got["det_valid"][idx]]),
                                      np.sort(want["det_amp"][idx][want["det_valid"][idx]]))


# ------------------------------------------------------------------- the bus
@pytest.fixture(scope="module")
def bus(tmp_path_factory):
    """simulate -> ingest -> mtd -> detect through both packages, both
    formats; the port's ``detect`` reads the JAX package's RDM files."""
    root = tmp_path_factory.mktemp("bus")
    d = {"cap": str(root / "cap")}
    assert jcli.main(["simulate", "--output", d["cap"], "--profile", "TINY", "--frames", "3",
                      "--velocity", "-5.7", "--range", "60", "--scr", "25"]) == 0
    for pkg, main, extra in (("jax", jcli.main, []), ("port", tcli.main, PORT)):
        for fmt in ("npz", "mat"):
            d[pkg, fmt, "f"] = str(root / f"{pkg}_{fmt}_frames")
            d[pkg, fmt, "r"] = str(root / f"{pkg}_{fmt}_rdm")
            d[pkg, fmt, "d"] = str(root / f"{pkg}_{fmt}_det")
            d[pkg, fmt, "s"] = str(root / f"{pkg}_{fmt}_sweep")
            common = ["--profile", "TINY", "--format", fmt] + extra
            assert main(["ingest", "--input", d["cap"], "--output", d[pkg, fmt, "f"],
                         "--frames", "3"] + common) == 0
            assert main(["mtd", "--input", d[pkg, fmt, "f"], "--output", d[pkg, fmt, "r"],
                         "--frames", "2", "--win-size", "2"] + common) == 0
            # both detect commands read the JAX package's RDM files
            assert main(["detect", "--input", d["jax", fmt, "r"], "--output",
                         d[pkg, fmt, "d"], "--frames", "2", "--threshold", "5"] + common) == 0
            assert main(["detect", "--input", d["jax", fmt, "r"], "--output",
                         d[pkg, fmt, "s"], "--frames", "2", "--thresholds", "3", "5",
                         "7.5"] + common) == 0
    return d


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_ingest_equals_jax(bus, fmt):
    for f in range(3):
        if fmt == "npz":
            got, gprof, gmeta = tload_frame(bus["port", fmt, "f"], f)
            want, wprof, wmeta = jload_frame(bus["jax", fmt, "f"], f)
            assert gprof == as_config(wprof, tconfig) and gmeta == wmeta == {"dbf": False}
            path = lambda pkg: os.path.join(bus[pkg, fmt, "f"], f"frame_{f}.npz")  # noqa: E731
            # the embedded profile and meta are the same bytes
            for key in ("__profile__", "__meta__"):
                assert _raw(path("port"), key) == _raw(path("jax"), key)
        else:
            got = _mat_vars(tmatbus.mat_frame_path(bus["port", fmt, "f"], f))
            want = _mat_vars(jmatbus.mat_frame_path(bus["jax", fmt, "f"], f))
        assert sorted(got) == sorted(want) and "servo_angle" in got
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert got[("iq" if fmt == "npz" else "sig_data_DBF_allprts")].shape == (32, 344, 2)


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_mtd_matches_jax(bus, fmt):
    for f in range(2):
        if fmt == "npz":
            got, gprof, gmeta = tload_frame(bus["port", fmt, "r"], f)
            want, _, wmeta = jload_frame(bus["jax", fmt, "r"], f)
            assert gmeta == wmeta == {"win_size": 2, "istc": False} and gprof.name == "G2"
            np.testing.assert_array_equal(got["servo_angle"], want["servo_angle"])
            got, want = got["rdm"], want["rdm"]
        else:
            got = tmatbus.load_mtd_mat(tmatbus.mat_frame_path(bus["port", fmt, "r"], f))
            want = jmatbus.load_mtd_mat(jmatbus.mat_frame_path(bus["jax", fmt, "r"], f))
            assert "MTD_win_all_beams" in _mat_vars(tmatbus.mat_frame_path(bus["port", fmt, "r"], f))
        assert got.shape == want.shape == (2, 2, 32, 344) and got.dtype == np.float32
        _assert_rdm_close(got, want)


def test_mat_bus_matches_npz_bus(bus):
    """The port's mat chain holds the same numbers as its npz chain."""
    for f in range(2):
        npz = tload_frame(bus["port", "npz", "r"], f)[0]["rdm"]
        mat = tmatbus.load_mtd_mat(tmatbus.mat_frame_path(bus["port", "mat", "r"], f))
        np.testing.assert_array_equal(mat, npz)
        flags = tload_frame(bus["port", "npz", "d"], f)[0]["flags"]
        mat_flags = tmatbus.load_cfar_mat(tmatbus.mat_frame_path(bus["port", "mat", "d"], f))
        np.testing.assert_array_equal(mat_flags, flags)


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_detect_flags_equal_jax(bus, fmt):
    for f in range(2):
        if fmt == "npz":
            got, _, gmeta = tload_frame(bus["port", fmt, "d"], f)
            want, _, wmeta = jload_frame(bus["jax", fmt, "d"], f)
            assert gmeta == wmeta == {"threshold": 5.0}
            assert got["det_valid"].shape == (2, 2, 64)       # --max-detections 64
            _assert_same_detections(got, want)
        else:
            got = _mat_vars(tmatbus.mat_frame_path(bus["port", fmt, "d"], f))
            want = _mat_vars(jmatbus.mat_frame_path(bus["jax", fmt, "d"], f))
            assert sorted(got) == sorted(want) == ["cfarFlag_win_0", "cfarFlag_win_1"]
            for key in want:
                assert got[key].dtype == want[key].dtype == np.float64
                np.testing.assert_array_equal(got[key], want[key])
    # the target's mid-segment cell (column 24 + 10) in beam 0
    arrays = tload_frame(bus["port", "npz", "d"], 0)[0]
    cols = set(arrays["det_r"][0, 0][arrays["det_valid"][0, 0]].tolist())
    assert any(abs(c - 34) <= 1 for c in cols), cols


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_detect_thresholds_match_jax(bus, fmt):
    """``--thresholds``: the reference's directory names (``OUTPUT_T{t}``,
    or ``cfarFlag{win}_T{t}`` under OUTPUT), each equal to the JAX
    package's and the T=5 one to the single-threshold run."""
    names = ("3", "5", "7.5")
    for t in names:
        for f in range(2):
            if fmt == "npz":
                got = tload_frame(f"{bus['port', fmt, 's']}_T{t}", f)
                want = jload_frame(f"{bus['jax', fmt, 's']}_T{t}", f)
                assert got[2] == want[2] == {"threshold": float(t)}
                _assert_same_detections(got[0], want[0])
                if t == "5":
                    _assert_same_detections(got[0], tload_frame(bus["port", fmt, "d"], f)[0])
            else:
                sub = f"cfarFlag2_T{t}"
                got = tmatbus.load_cfar_mat(tmatbus.mat_frame_path(
                    os.path.join(bus["port", fmt, "s"], sub), f))
                want = jmatbus.load_cfar_mat(jmatbus.mat_frame_path(
                    os.path.join(bus["jax", fmt, "s"], sub), f))
                np.testing.assert_array_equal(got, want)
                if t == "5":
                    np.testing.assert_array_equal(got, tmatbus.load_cfar_mat(
                        tmatbus.mat_frame_path(bus["port", fmt, "d"], f)))
    if fmt == "mat":
        assert sorted(os.listdir(bus["port", fmt, "s"])) == sorted(
            os.listdir(bus["jax", fmt, "s"])) == [f"cfarFlag2_T{t}" for t in names]
    low = tload_frame(f"{bus['port', 'npz', 's']}_T3", 0)[0]["flags"]
    high = tload_frame(f"{bus['port', 'npz', 's']}_T7.5", 0)[0]["flags"]
    assert low.sum() >= high.sum()


@pytest.mark.parametrize("interp", [1, 4])
def test_detect_spectral_width_matches_jax(bus, tmp_path, interp):
    argv = ["detect", "--input", bus["jax", "npz", "r"], "--profile", "TINY", "--frames", "1",
            "--spectral-width-db", "-15.0", "--spectral-width-interp", str(interp)]
    assert tcli.main(argv + ["--output", str(tmp_path / "port")] + PORT) == 0
    assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    got = tload_frame(str(tmp_path / "port"), 0)[0]
    want = jload_frame(str(tmp_path / "jax"), 0)[0]
    _assert_same_detections(got, want)
    assert got["det_width"].shape == want["det_width"].shape == (2, 2, 64)
    for idx in np.ndindex(2, 2):
        gv, wv = got["det_valid"][idx], want["det_valid"][idx]
        g = dict(zip(got["det_r"][idx][gv].tolist(), got["det_width"][idx][gv].tolist()))
        w = dict(zip(want["det_r"][idx][wv].tolist(), want["det_width"][idx][wv].tolist()))
        assert g.keys() == w.keys() and g
        np.testing.assert_allclose([g[r] for r in w], list(w.values()), rtol=0, atol=1e-5)


def test_detect_mat_spectral_width_warns_once(bus, tmp_path, caplog):
    """``--format mat`` cannot hold widths: one warning (the JAX text), the
    cfarFlag variables still written."""
    import logging

    out = str(tmp_path / "det")
    with caplog.at_level(logging.WARNING, logger="radar_signal_process_tpu_torch.cli"):
        assert tcli.main(["detect", "--input", bus["jax", "mat", "r"], "--output", out,
                          "--profile", "TINY", "--frames", "2", "--format", "mat",
                          "--spectral-width-db", "-15.0"] + PORT) == 0
    warnings = [r for r in caplog.records if "spectral widths" in r.message]
    assert len(warnings) == 1
    assert warnings[0].message.startswith("--format mat writes only the reference's cfarFlag")
    assert sorted(_mat_vars(tmatbus.mat_frame_path(out, 1))) == ["cfarFlag_win_0",
                                                                 "cfarFlag_win_1"]


# ------------------------------------------------------------- cross-reads
@pytest.mark.parametrize("stage", ["f", "r", "d"], ids=["stage1", "rdm", "flags"])
def test_npz_artifacts_cross_read(bus, stage):
    """Each package's loader reads the other's ``.npz`` artifacts: equal
    arrays, an equal profile, equal meta."""
    for pkg in ("jax", "port"):
        directory = bus[pkg, "npz", stage]
        got, gprof, gmeta = tload_frame(directory, 0)
        want, wprof, wmeta = jload_frame(directory, 0)
        assert type(gprof) is tconfig.RadarProfile and type(wprof) is jconfig.RadarProfile
        assert as_config(wprof, tconfig) == gprof and as_config(gprof, jconfig) == wprof
        assert gprof == as_config(TINY, tconfig) and gmeta == wmeta
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("stage", ["f", "r", "d"], ids=["stage1", "rdm", "flags"])
def test_mat_artifacts_cross_read(bus, stage):
    load = {"f": "load_frame_mat", "r": "load_mtd_mat", "d": "load_cfar_mat"}[stage]
    for pkg in ("jax", "port"):
        path = tmatbus.mat_frame_path(bus[pkg, "mat", stage], 1)
        got, want = getattr(tmatbus, load)(path), getattr(jmatbus, load)(path)
        for g, w in zip(got if stage == "f" else (got,), want if stage == "f" else (want,)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_mtd_reads_the_mat_stage1_bus(bus, tmp_path):
    """A MATLAB-form stage-1 directory feeds the npz MTD stage: the RDMs
    equal those of the npz stage-1 directory bit for bit."""
    out = str(tmp_path / "rdm")
    assert tcli.main(["mtd", "--input", bus["jax", "mat", "f"], "--output", out,
                      "--profile", "TINY", "--frames", "1", "--win-size", "2"] + PORT) == 0
    np.testing.assert_array_equal(tload_frame(out, 0)[0]["rdm"],
                                  tload_frame(bus["port", "npz", "r"], 0)[0]["rdm"])


# --------------------------------------------------------------- idempotence
@pytest.mark.parametrize("cmd", ["ingest", "mtd", "detect"])
def test_stage_skips_existing_frames_unless_forced(bus, tmp_path, cmd):
    src = {"ingest": bus["cap"], "mtd": bus["port", "npz", "f"],
           "detect": bus["port", "npz", "r"]}[cmd]
    out = str(tmp_path / "out")
    argv = [cmd, "--input", src, "--output", out, "--profile", "TINY", "--frames", "2"] + PORT
    assert tcli.main(argv) == 0
    path = os.path.join(out, "frame_0.npz")
    want = open(path, "rb").read()
    with open(path, "wb") as fh:             # a marker in place of frame 0
        np.savez(fh, marker=np.zeros(1))
    assert tcli.main(argv) == 0
    assert set(np.load(path).files) == {"marker"}           # skipped
    assert tcli.main(argv + ["--force"]) == 0
    assert open(path, "rb").read() == want                  # rewritten
    assert not [p for p in os.listdir(out) if p.endswith(".tmp")]


# ----------------------------------------------------------------------- DBF
def test_ingest_dbf_matches_jax(bus, tmp_path, rng):
    """``ingest --dbf-coeffs``: the beams within f32 rounding of the JAX
    package's and of a complex128 einsum of the stage-1 channels."""
    coeffs = rng.standard_normal((3, 2)) + 1j * rng.standard_normal((3, 2))
    path = tmp_path / "dbf.txt"
    inter = np.empty((3, 4))
    inter[:, 0::2], inter[:, 1::2] = coeffs.real, coeffs.imag
    np.savetxt(path, inter)
    argv = ["ingest", "--input", bus["cap"], "--profile", "TINY", "--frames", "3",
            "--dbf-coeffs", str(path)]
    assert tcli.main(argv + ["--output", str(tmp_path / "port")] + PORT) == 0
    assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    for f in range(3):
        got, _, meta = tload_frame(str(tmp_path / "port"), f)
        want = jload_frame(str(tmp_path / "jax"), f)[0]
        assert meta == {"dbf": True} and got["iq"].dtype == np.complex64
        assert got["iq"].shape == want["iq"].shape == (32, 344, 3)
        channels = tload_frame(bus["port", "npz", "f"], f)[0]["iq"]
        exact = np.einsum("psc,bc->psb", channels.astype(np.complex128),
                          coeffs.astype(np.complex64).astype(np.complex128))
        peak = np.abs(exact).max()
        np.testing.assert_allclose(got["iq"], exact, rtol=0, atol=1e-6 * peak)
        np.testing.assert_allclose(got["iq"], want["iq"], rtol=0, atol=1e-6 * peak)
        np.testing.assert_array_equal(got["servo_angle"], want["servo_angle"])


# --------------------------------------------------------------- mtd hooks
@pytest.fixture(scope="module")
def hooks(tmp_path_factory):
    root = tmp_path_factory.mktemp("hooks")
    curve = root / "stcCurve.txt"
    curve.write_text("\n".join(f"{v:.6f}" for v in np.linspace(20.0, 0.0, 40)))
    rng = np.random.default_rng(3)
    wf = np.exp(1j * np.pi * np.linspace(-1, 1, 40) ** 2) * (1.0 + 0.05 * rng.standard_normal(40))
    np.savez(root / "mw.npz", refData=wf)
    return {"istc": ["--istc", str(curve)],
            "match-waveform": ["--match-waveform", f"1={root / 'mw.npz'}:refData"]}


@pytest.mark.parametrize("hook", ["istc", "match-waveform", "both"])
def test_mtd_hooks_match_jax(bus, hooks, tmp_path, hook):
    extra = hooks["istc"] + hooks["match-waveform"] if hook == "both" else hooks[hook]
    argv = ["mtd", "--input", bus["jax", "npz", "f"], "--profile", "TINY", "--frames", "1",
            "--win-size", "2"] + extra
    assert tcli.main(argv + ["--output", str(tmp_path / "port")] + PORT) == 0
    assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    got, _, gmeta = tload_frame(str(tmp_path / "port"), 0)
    want, _, wmeta = jload_frame(str(tmp_path / "jax"), 0)
    assert gmeta == wmeta == {"win_size": 2, "istc": hook != "match-waveform"}
    _assert_rdm_close(got["rdm"], want["rdm"])
    plain = tload_frame(bus["port", "npz", "r"], 0)[0]["rdm"]
    assert not np.allclose(got["rdm"], plain, rtol=1e-3)


def test_mtd_rejects_bad_match_waveform_spec(bus, tmp_path):
    with pytest.raises(SystemExit, match="SEG=PATH"):
        tcli.main(["mtd", "--input", bus["port", "npz", "f"], "--output", str(tmp_path),
                   "--profile", "TINY", "--match-waveform", "1"] + PORT)


# ------------------------------------------------------------------------ G1
@pytest.fixture(scope="module")
def g1_capture(tmp_path_factory):
    from radar_signal_process_tpu.sim.packets_synth import write_g1_capture

    root = tmp_path_factory.mktemp("g1")
    rng = np.random.default_rng(7)
    shape = (3, 32, 344)
    left = rng.integers(-60000, 60000, shape) + 1j * rng.integers(-60000, 60000, shape)
    right = rng.integers(-60000, 60000, shape) + 1j * rng.integers(-60000, 60000, shape)
    write_g1_capture(str(root / "cap"), left, right, frames_per_file=2, angle_deg=33.0,
                     freq_index=[3, 7, 1])
    return root


@pytest.mark.parametrize("fmt", ["npz", "mat"])
def test_ingest_g1_equals_jax(g1_capture, fmt):
    """G1 stage 1 (``MatlabProcess_xuzerui/bin_to_mat_xzr.m``): the
    ``iq`` stack and header meta, or ``echoData_Frame_0/1`` +
    ``angleCodeSeries``, bit for bit; ``--debug-plots`` writes the same
    files."""
    out = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("port", tcli.main, PORT)):
        out[pkg] = g1_capture / f"{pkg}_{fmt}"
        dbg = ["--debug-plots", str(g1_capture / f"{pkg}_dbg")] if fmt == "npz" else []
        assert main(["ingest", "--input", str(g1_capture / "cap"), "--output", str(out[pkg]),
                     "--profile", "TG1", "--frames", "5", "--frames-per-file", "2",
                     "--format", fmt] + dbg + extra) == 0
    names = sorted(os.listdir(out["port"]))
    assert names == sorted(os.listdir(out["jax"])) == [f"frame_{f}.{fmt}" for f in range(3)]
    for f in range(3):
        if fmt == "npz":
            got, gprof, gmeta = tload_frame(str(out["port"]), f)
            want, wprof, wmeta = jload_frame(str(out["jax"]), f)
            assert gprof == as_config(wprof, tconfig) and gmeta == wmeta
            assert gmeta["freq_index"] == (3, 7, 1)[f] and gmeta["dbf"] is False
        else:
            got = _mat_vars(tmatbus.mat_frame_path(str(out["port"]), f))
            want = _mat_vars(jmatbus.mat_frame_path(str(out["jax"]), f))
            assert sorted(got) == ["angleCodeSeries", "echoData_Frame_0", "echoData_Frame_1"]
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    if fmt == "npz":
        assert sorted(os.listdir(g1_capture / "port_dbg")) == sorted(
            os.listdir(g1_capture / "jax_dbg")) == [f"iq_frame_{f}.png" for f in range(3)]


@pytest.mark.parametrize("native", ["--native", "--no-native"])
def test_ingest_g1_end_of_capture_stops_cleanly(g1_capture, tmp_path, native):
    out = str(tmp_path / "frames")
    assert tcli.main(["ingest", "--input", str(g1_capture / "cap"), "--output", out,
                      "--profile", "TG1", "--frames", "6", "--frames-per-file", "2",
                      native] + PORT) == 0
    assert sorted(os.listdir(out)) == [f"frame_{f}.npz" for f in range(3)]


def test_mtd_g1_two_beam_mat_contract(g1_capture, tmp_path):
    """G1 stage 2 with ``--format mat`` writes the ``MTD_0``/``MTD_1`` pair
    (``MTD/main_produce_dataset_win_xzr.m:37-42``), equal within the RDM
    tolerance to the JAX package's."""
    frames = str(tmp_path / "frames")
    assert tcli.main(["ingest", "--input", str(g1_capture / "cap"), "--output", frames,
                      "--profile", "TG1", "--frames", "2", "--frames-per-file", "2"] + PORT) == 0
    argv = ["mtd", "--input", frames, "--profile", "TG1", "--frames", "1", "--win-size", "2",
            "--format", "mat"]
    assert tcli.main(argv + ["--output", str(tmp_path / "port")] + PORT) == 0
    assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    got = _mat_vars(tmatbus.mat_frame_path(str(tmp_path / "port"), 0))
    want = _mat_vars(jmatbus.mat_frame_path(str(tmp_path / "jax"), 0))
    assert sorted(got) == sorted(want) == ["MTD_0", "MTD_1"]
    for key in want:
        assert got[key].shape == want[key].shape == (2, 32, 344)
        _assert_rdm_close(got[key], want[key])
    stack = tmatbus.load_mtd_mat(tmatbus.mat_frame_path(str(tmp_path / "port"), 0))
    assert stack.shape == (2, 2, 32, 344)


# ------------------------------------------------------------------- analyze
def test_analyze_writes_the_jax_files(bus, tmp_path, capsys):
    """``analyze --animate all``: the dashboard, the Doppler and the PC
    animations, under the JAX package's file names."""
    argv = ["analyze", "--input", bus["jax", "npz", "r"], "--profile", "TINY", "--frame", "1",
            "--beam", "1", "--win-slice", "1", "--animate", "all", "--stage1-input",
            bus["jax", "npz", "f"], "--animate-step", "16", "--animate-frames", "3"]
    capsys.readouterr()
    assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert tcli.main(argv + ["--output", str(tmp_path / "port")] + PORT) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "frame_1_b1_s1.png", "doppler_anim.gif", "pc_anim.gif"]
    assert all(os.path.getsize(p) > 500 for p in got)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_analyze_reads_the_mat_bus(bus, tmp_path, capsys):
    capsys.readouterr()
    assert tcli.main(["analyze", "--input", bus["port", "mat", "r"], "--output",
                      str(tmp_path / "viz"), "--profile", "TINY", "--animate", "doppler",
                      "--animate-frames", "2"] + PORT) == 0
    outs = capsys.readouterr().out.strip().splitlines()
    assert [os.path.basename(p) for p in outs] == ["frame_0_b0_s0.png", "doppler_anim.gif"]


def test_analyze_pc_animation_needs_stage1(bus, tmp_path):
    with pytest.raises(SystemExit, match="stage1-input"):
        tcli.main(["analyze", "--input", bus["port", "npz", "r"], "--output", str(tmp_path),
                   "--profile", "TINY", "--animate", "pc"] + PORT)


# -------------------------------------------------------------------- stream
def test_stream_hooks_match_jax(tmp_path, capsys):
    """``stream --istc --match-waveform``: per window the CFAR hits and the
    detections per beam equal the JAX stream's."""
    cap = str(tmp_path / "cap")
    assert jcli.main(["simulate", "--output", cap, "--profile", "TINYS", "--frames", "3",
                      "--velocity", "4.0", "--range", "60", "--scr", "25"]) == 0
    np.savetxt(tmp_path / "stc.txt", np.linspace(0, 6, 50))
    wf = np.exp(1j * np.pi * np.linspace(-1, 1, 40) ** 2) * 1.2
    np.savez(tmp_path / "mw.npz", refData=wf)
    capsys.readouterr()
    argv = ["stream", "--input", cap, "--profile", "TINYS", "--frames", "3", "--win-size", "2",
            "--istc", str(tmp_path / "stc.txt"), "--match-waveform",
            f"1={tmp_path / 'mw.npz'}:refData", "--no-native"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(argv + PORT) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    plain = argv[: argv.index("--istc")] + ["--no-native"] + PORT
    assert tcli.main(plain) == 0
    base = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [f["frame"] for f in got["frames"]] == [f["frame"] for f in want["frames"]] == [0, 1]
    for g, w in zip(got["frames"], want["frames"]):
        assert (g["cfar_hits"], g["detections_per_beam"]) == (
            w["cfar_hits"], w["detections_per_beam"])
    assert [f["cfar_hits"] for f in base["frames"]] != [f["cfar_hits"] for f in got["frames"]]


# ---------------------------------------------------------------- e2e --mesh
def test_e2e_mesh_reports_the_jax_rows_with_more_channels_than_beams(tmp_path, capsys):
    """``e2e --mesh 1x1`` over a capture of 3 channels with a profile of 2
    beams prints the JAX package's rows (ROADMAP C11): rows ``[:n_beams]``
    of the slice, those of the port's ``e2e`` for channels 0 and 1, where
    the plain ``e2e`` also reports channel 2."""
    cap = str(tmp_path / "cap")
    assert jcli.main(["simulate", "--output", cap, "--profile", "TINYC", "--frames", "3",
                      "--velocity", "-5.7", "--range", "60", "--scr", "25"]) == 0
    argv = ["e2e", "--input", cap, "--profile", "TINYC", "--frames", "2", "--win-slice", "1"]
    capsys.readouterr()

    def rows(main, extra):
        assert main(argv + extra) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["frames"]

    want = rows(jcli.main, ["--mesh", "1x1"])
    got = rows(tcli.main, ["--mesh", "1x1"] + PORT)
    plain = rows(tcli.main, PORT)
    assert [f["frame"] for f in got] == [f["frame"] for f in want] == [0, 1]
    assert any(r[0] == 2 for f in plain for r in f["detections"])
    assert all(f["detections"] for f in want)
    for g, w, p in zip(got, want, plain):
        gs, ws = sorted(g["detections"]), sorted(w["detections"])
        assert [r[:4] for r in gs] == [r[:4] for r in ws]
        np.testing.assert_allclose([r[4] for r in gs], [r[4] for r in ws], rtol=1e-4)
        assert gs == sorted(r for r in p["detections"] if r[0] < 2 and r[1] == 1)

"""The port's simulation harness, detection metrics and threshold sweep
against the JAX package.

The ``sim`` copies and the metrics are numpy in both packages: equal bit
for bit.  ``sweep_thresholds`` runs the whole chain (``mtd_produce``, the
re-notch, B1's plain version per threshold) and must give the JAX table:
Pd, accuracy and PCF equal, the false-alarm rate within 2 cells per frame
(the RDMs differ by FFT rounding: the JAX chain runs in complex128 here,
``tests/conftest.py`` enables x64).  ``cli simulate`` writes the JAX
package's bytes, ``cli sweep`` prints its table.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu import evalx as jevalx
from radar_signal_process_tpu import sim as jsim
from radar_signal_process_tpu.evalx import sweep as jsweep
from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce as jax_mtd_produce
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch import evalx as tevalx
from radar_signal_process_tpu_torch import sim as tsim
from radar_signal_process_tpu_torch.evalx import sweep as tsweep
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.models.detect import clutter_cells, renotch_mask
from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from tests.test_sweep_windows import SMALL
from tests.test_torch_import import as_config

torch.set_num_threads(2)

T_SMALL = as_config(SMALL, tconfig)
G1 = jconfig.G1_PROFILE


# ----------------------------------------------------------------------- sim
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("profile", ["G2", "G1", "SMALL"])
def test_sim_copies_equal_the_jax_package(seed, profile):
    jprof = {"G2": jconfig.G2_PROFILE, "G1": G1, "SMALL": SMALL}[profile]
    tprof = as_config(jprof, tconfig)
    n = 24
    target_j = jsim.synthesize_target_echo(jprof, -5.7, 320.0, n_pulses=n, amplitude=2.0,
                                           initial_phase=0.3)
    target_t = tsim.synthesize_target_echo(tprof, -5.7, 320.0, n_pulses=n, amplitude=2.0,
                                           initial_phase=0.3)
    np.testing.assert_array_equal(target_t, target_j)
    scene = ((-5.7, 320.0, 1.0), (8.0, 100.0, 0.5))
    np.testing.assert_array_equal(tsim.synthesize_scene(tprof, scene, n, seed=seed),
                                  jsim.synthesize_scene(jprof, scene, n, seed=seed))
    clutter_j = jsim.synthetic_clutter(jprof, n_pulses=n, seed=seed)
    clutter_t = tsim.synthetic_clutter(tprof, n_pulses=n, seed=seed)
    np.testing.assert_array_equal(clutter_t, clutter_j)
    for scr in (-10.0, 15.0):
        np.testing.assert_array_equal(
            tsim.add_clutter(tsim.apply_scr(target_t, clutter_t, scr, tprof), clutter_t),
            jsim.add_clutter(jsim.apply_scr(target_j, clutter_j, scr, jprof), clutter_j))


# ------------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_package(seed):
    """Random flag planes and RDMs, truths inside and outside the gate."""
    rng = np.random.default_rng(seed)
    nv, nr = 48, 300
    r_axis = np.arange(nr) * 6.0
    v_axis = np.linspace(-12.0, 12.0, nv)
    flags = [rng.random((nv, nr)) < p for p in (0.002, 0.01, 0.0, 0.05)]
    rdms = [rng.random((nv, nr)).astype(np.float32) for _ in flags]
    r_true = [600.0, 1200.0, 800.0, 300.0]      # the last outside the range gate
    v_true = [-5.7, 8.0, 4.0, -6.0]
    for gate in (jevalx.TruthGate(), jevalx.TruthGate(r_min=100.0, v_half=1, r_half=3)):
        tgate = tevalx.TruthGate(**dataclasses.asdict(gate))
        want = jevalx.evaluate_frames(flags, rdms, r_true, v_true, r_axis, v_axis, gate)
        got = tevalx.evaluate_frames(flags, rdms, r_true, v_true, r_axis, v_axis, tgate)
        assert got == want or (json.dumps(got) == json.dumps(want))
        for f, rt, vt in zip(flags, r_true, v_true):
            assert tevalx.false_alarm_rate(f, rt, vt, r_axis, v_axis, tgate) == \
                jevalx.false_alarm_rate(f, rt, vt, r_axis, v_axis, gate)


# --------------------------------------------------------------------- sweep
SWEEP = dict(thresholds=[3.0, 4.3, 7.0], scr_db=[-40.0, 10.0, 25.0], velocity_ms=-8.0,
             range_m=60.0, n_frames=2, clutter_v=1.0)


def _assert_same_table(got, want, n_frames, cells):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        for m in ("detection_rate", "accuracy", "localization_pcf"):
            assert g[m] == w[m] or (np.isnan(g[m]) and np.isnan(w[m])), (key, m)
        # the FA rate is a mean over frames of flags / cells
        assert abs(g["false_alarm_rate"] - w["false_alarm_rate"]) <= 2 / cells, key


def test_sweep_matches_jax():
    gate = dict(r_min=100.0, r_max=2000.0)
    want = jsweep.sweep_thresholds(SMALL, gate=jevalx.TruthGate(**gate), **SWEEP)
    got = tsweep.sweep_thresholds(T_SMALL, gate=tevalx.TruthGate(**gate), device="cpu", **SWEEP)
    _assert_same_table(got, want, 2, SMALL.prt_per_frame * SMALL.point_prt)
    assert got[(25.0, 4.3)]["detection_rate"] == 1.0
    assert tsweep.format_sweep(got).splitlines()[0] == jsweep.format_sweep(want).splitlines()[0]


@pytest.mark.parametrize("scr", [-40.0, 25.0])
def test_sweep_flags_are_the_ref_level_form(scr):
    """The sweep's flags (B1's plain version per threshold on the re-notched
    batch) equal the ported ref-level form's, and the RDM batch is the JAX
    ``mtd_produce`` of the same echoes within the RDM tolerance."""
    n = SMALL.prt_per_frame
    target = tsim.synthesize_target_echo(T_SMALL, -8.0, 60.0, n_pulses=n)
    echo = []
    for f in range(2):
        clutter = tsim.synthetic_clutter(T_SMALL, n_pulses=n, seed=97 * f)
        echo.append(tsim.add_clutter(tsim.apply_scr(target, clutter, scr, T_SMALL), clutter))
    echo = np.stack(echo).astype(np.complex64)
    rdm = mtd_produce(torch.from_numpy(echo), T_SMALL)
    want = np.asarray(jax_mtd_produce(jnp.asarray(echo), SMALL))
    peak = np.abs(want).max()
    np.testing.assert_allclose(rdm.numpy() / peak, want / peak, rtol=2e-4, atol=2e-5)
    nc = clutter_cells(T_SMALL, n, 1.0)
    rdmn = rdm * torch.from_numpy(renotch_mask(T_SMALL, n, nc, 20))[:, None]
    vref, rref = tcfar.segmented_cfar_ref_levels(rdmn, T_SMALL.cfar_segments, T_SMALL.cfar, nc)
    for t in SWEEP["thresholds"]:
        cfg = dataclasses.replace(T_SMALL.cfar, threshold=t)
        flags, _ = kcfar.cascaded_cfar2d(rdmn, cfg, nc, T_SMALL.cfar_segments)
        ref_flags, _ = tcfar.segmented_cfar_from_ref_levels(
            rdmn, vref, rref, t, T_SMALL.cfar_segments, T_SMALL.cfar, nc)
        assert torch.equal(flags, ref_flags)


# ----------------------------------------------------------------------- CLI
@pytest.fixture
def small_profiles(monkeypatch):
    """Both packages' profile tables get the reduced G2 geometry as "G2"."""
    monkeypatch.setitem(jconfig.PROFILES, "G2", SMALL)
    monkeypatch.setitem(tconfig.PROFILES, "G2", T_SMALL)


def test_cli_simulate_writes_the_jax_bytes(tmp_path, small_profiles):
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    args = ["--frames", "3", "--velocity", "4.0", "--range", "60", "--scr", "25",
            "--seed", "3", "--file-bytes", "40000"]
    assert jcli.main(["simulate", "--output", str(tmp_path / "ref")] + args) == 0
    assert tcli.main(["simulate", "--output", str(tmp_path / "port")] + args) == 0
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(names) > 1 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_cli_sweep_cpu_matches_jax_cli(capsys, small_profiles):
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    args = ["sweep", "--thresholds", "3", "5", "--scr", "0", "20", "--frames", "2",
            "--velocity", "-8", "--range", "300", "--clutter-v", "1"]
    assert jcli.main(args) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 6
    got_m, want_m = json.loads(got[-1]), json.loads(want[-1])
    assert list(got_m) == list(want_m) == ["0.0/3.0", "0.0/5.0", "20.0/3.0", "20.0/5.0"]
    cells = SMALL.prt_per_frame * SMALL.point_prt
    for key, w in want_m.items():
        g = got_m[key]
        for m in ("detection_rate", "accuracy", "localization_pcf"):
            assert g[m] == w[m], (key, m)
        assert abs(g["false_alarm_rate"] - w["false_alarm_rate"]) <= 2 / cells, key

"""The G1 validation chain, single-CPI ``mtd_produce``, ``detect_rdm`` and
``cli e2e`` of the port against the JAX package.

RDMs agree within the repo's f32 tolerance relative to their peak
(``tests/test_torch_slice.py``: rtol 2e-4, atol 2e-5 of the peak): the JAX
package takes the XLA FFT where the port's plain version takes the B2
matmul.  Flags are compared by running each package's CFAR on the other's
RDM, where they are bit-equal.  G1 keeps its 1031 fast-time columns (the
range re-concatenation fixes them) and cuts the pulse count.  Inputs are
explicit complex64/float32 (``tests/conftest.py`` enables x64).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu import sim as jsim
from radar_signal_process_tpu.models import detect as jdetect
from radar_signal_process_tpu.models.g1_chain import g1_validation_chain as jax_g1_chain
from radar_signal_process_tpu.models.g1_chain import make_g1_validation_chain as jax_make_g1
from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce as jax_mtd_produce
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu.ops import pulse_compression as jpc
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.models import detect as tdetect
from radar_signal_process_tpu_torch.models.g1_chain import (
    g1_validation_chain,
    make_g1_validation_chain,
)
from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops import pulse_compression as tpc
from tests.test_sweep_windows import SMALL
from tests.test_torch_import import as_config

torch.set_num_threads(2)

RTOL, PEAK_ATOL = 2e-4, 2e-5
G1_PULSES = 64     # cut from 1536; the chains take any pulse count
G1 = dataclasses.replace(jconfig.G1_PROFILE, prt_per_frame=G1_PULSES)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _assert_rdm_close(got, want):
    got, want = got.numpy() if isinstance(got, torch.Tensor) else got, np.asarray(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, rtol=RTOL, atol=PEAK_ATOL)


# ----------------------------------------------------------------------- ops
def test_range_concatenate_equal(rng):
    pc = _cplx(rng, (2, 8, 1031))
    got = tpc.range_concatenate(torch.from_numpy(pc), tconfig.G1_RANGE_CONCAT)
    want = jpc.range_concatenate(jnp.asarray(pc), jconfig.G1_RANGE_CONCAT)
    assert got.shape == (2, 8, 868) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_fft,shift", [(None, True), (None, False), (48, True)])
def test_doppler_process_range_major(rng, n_fft, shift):
    pc = _cplx(rng, (3, 40, 70))
    window = np.kaiser(40, 8.0)
    got = tmtd.doppler_process_range_major(torch.from_numpy(pc), window, n_fft, shift)
    want = jmtd.doppler_process_range_major(jnp.asarray(pc), window, n_fft, shift)
    assert got.shape == (3, 70, n_fft or 40)
    _assert_rdm_close(got, want)
    # the range-major form is the transposed velocity-major form
    np.testing.assert_allclose(
        got.numpy(), tmtd.doppler_process(torch.from_numpy(pc), window, n_fft, shift).mT.numpy(),
        rtol=1e-6, atol=1e-5)


# ----------------------------------------------------------- mtd_produce
UNSHIFTED = dataclasses.replace(
    SMALL, mtd=jconfig.MTDConfig(window="hamming", notch_divisor=0, fft_length=96,
                                 fftshift=False))


@pytest.mark.parametrize("variant", ["shifted", "unshifted", "mti", "istc", "pulses", "batch"])
def test_mtd_produce_matches_jax(rng, variant):
    prof, kw, shape = SMALL, {}, (SMALL.prt_per_frame, SMALL.point_prt)
    if variant == "unshifted":
        prof = UNSHIFTED
    elif variant == "mti":
        prof = dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, mti_lag=8))
    elif variant == "istc":
        prof = dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, istc=True))
        kw = {"stc_curve_db": rng.uniform(-20.0, 6.0, 200)}
    elif variant == "pulses":
        kw = {"pulses": tuple(0.5 * p for p in reference_pulses(SMALL))}
    elif variant == "batch":
        shape = (3, 2, 40, SMALL.point_prt)     # any leading axes, any pulse count
    echo = _cplx(rng, shape)
    want = np.asarray(jax_mtd_produce(jnp.asarray(echo), prof, **kw))
    got = mtd_produce(torch.from_numpy(echo), as_config(prof, tconfig), **kw)
    _assert_rdm_close(got, want)
    if variant == "shifted":
        assert (got[30:35] == 0).all() or (got[31] == 0).all()   # the /150 notch row


# -------------------------------------------------------------- detect_rdm
def _rdm(rng, nv=64, nr=256, notch=None):
    rdm = (np.abs(rng.standard_normal((2, nv, nr))) + 0.5).astype(np.float32)
    for b in range(2):
        rdm[b, rng.integers(5, nv - 5, 40), rng.integers(0, nr, 40)] += 30.0
    if notch is not None:
        rdm[:, notch] = 0.0
    rdm[..., [0, 31, 32, 111, 112, 255]] += 20.0      # SMALL's segment edges
    return rdm


@pytest.mark.parametrize("case", ["renotch-20", "renotch-8", "no-renotch", "unshifted",
                                  "cfg-E2-T4.3"])
def test_detect_rdm_matches_jax(rng, case):
    prof, kw, nc = SMALL, {}, 2
    if case == "renotch-8":
        kw = {"renotch_divisor": 8}
    elif case == "no-renotch":
        kw = {"renotch_divisor": None}
    elif case == "unshifted":
        prof = dataclasses.replace(UNSHIFTED, cfar_segments=SMALL.cfar_segments)
        nc = 4
    elif case == "cfg-E2-T4.3":
        kw = {"cfg": jconfig.CFARConfig(threshold=4.3, range_extend_cells=2)}
    rdm = _rdm(rng, nv=96 if case == "unshifted" else 64)
    want_f, want_v = jdetect.detect_rdm(jnp.asarray(rdm), prof, nc, use_pallas=False, **kw)
    tkw = {k: as_config(v, tconfig) for k, v in kw.items()}
    got_f, got_v = tdetect.detect_rdm(torch.from_numpy(rdm), as_config(prof, tconfig), nc, **tkw)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert int(got_f.sum()) > 0
    # the detector module holds the same re-notch as a buffer
    det = tdetect.make_detector(as_config(prof, tconfig), n_clutter=nc, device="cpu", **tkw)
    f, v, _ = det(torch.from_numpy(rdm))
    assert torch.equal(f, got_f) and torch.equal(v, got_v)


# ------------------------------------------------------------------ G1 chain
def _g1_echo(n_pulses, seed=7):
    """The known target of ``tests/test_chains.py``: -5.7 m/s at 320 m, 15 dB
    SCR over seeded clutter, complex64."""
    target = jsim.synthesize_target_echo(G1, -5.7, 320.0, n_pulses=n_pulses)
    clutter = jsim.synthetic_clutter(G1, n_pulses=n_pulses, seed=seed)
    return (jsim.apply_scr(target, clutter, 15.0, G1) + clutter).astype(np.complex64)


def test_g1_chain_matches_jax_and_recovers_target():
    echo = np.stack([_g1_echo(G1_PULSES, 7), _g1_echo(G1_PULSES, 8)])   # two beams
    tprof = as_config(G1, tconfig)
    want = np.asarray(jax_g1_chain(jnp.asarray(echo), G1))
    got = g1_validation_chain(torch.from_numpy(echo), tprof)
    assert got.shape == (2, G1_PULSES, 868)
    _assert_rdm_close(got, want)
    # the notch and the target: argmax within 0.3 m/s, the mid-segment peak
    # at concatenated column 128 (tests/test_chains.py)
    v_axis = G1.velocity_axis(G1_PULSES)
    for b in range(2):
        vi, _ = np.unravel_index(int(np.argmax(got[b].numpy())), (G1_PULSES, 868))
        assert abs(v_axis[vi] - (-5.7)) < 0.3 + abs(v_axis[1] - v_axis[0])
        assert int(np.argmax(got[b, vi, 82:318].numpy())) + 82 == 128
    lo, hi = tmtd.notch_rows(G1_PULSES, G1.mtd.notch_divisor)
    assert (got[:, lo : hi + 1] == 0).all()
    # flags: each package's detector on the other's RDM.  At 64 pulses the
    # target's Doppler bin lies inside the divisor-20 re-notch, so the
    # detectors run without it (the /150 notch of the chain stays)
    nc = jdetect.clutter_cells(G1, G1_PULSES)
    j_det = jdetect.make_detector(G1, n_clutter=nc, renotch_divisor=None)
    t_det = tdetect.make_detector(tprof, n_clutter=nc, renotch_divisor=None, device="cpu")
    t_flags, _, _ = t_det(torch.from_numpy(np.array(want, np.float32)))
    j_flags, _, _ = j_det(jnp.asarray(got.numpy()))
    np.testing.assert_array_equal(t_flags.numpy(), np.asarray(j_det(jnp.asarray(want))[0]))
    np.testing.assert_array_equal(np.asarray(j_flags), t_det(got)[0].numpy())
    assert int(t_flags.sum()) > 0


def test_g1_chain_measured_pulses_and_buffers(rng):
    """The measured-pulse hook, and the module's buffers."""
    pulses = tuple(p * np.exp(1j * 0.4) for p in reference_pulses(G1))
    echo = _cplx(rng, (G1_PULSES, 1031))
    want = np.asarray(jax_make_g1(G1, pulses)(jnp.asarray(echo)))
    chain = make_g1_validation_chain(as_config(G1, tconfig), pulses, device="cpu")
    _assert_rdm_close(chain(torch.from_numpy(echo)), want)
    assert {"pc_spectrum_0", "pc_spectrum_1", "pc_spectrum_2"} <= set(dict(chain.named_buffers()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            make_g1_validation_chain()


# ------------------------------------------------------------------- cli e2e
TINY = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    n_channels=2, n_beams=2,
)


def test_cli_e2e_cpu_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``cli e2e`` of both packages over one capture written by the JAX
    ``cli simulate`` (the TINY geometry of ``tests/test_cli.py``): the same
    frames and, per (beam, slice), the same valid detection cells; the
    amplitudes agree within the RDM tolerance."""
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    monkeypatch.setitem(jconfig.PROFILES, "TINY", TINY)
    monkeypatch.setitem(tconfig.PROFILES, "TINY", as_config(TINY, tconfig))
    cap = str(tmp_path / "cap")
    assert jcli.main(["simulate", "--output", cap, "--profile", "TINY", "--frames", "3",
                      "--velocity", "4.0", "--range", "60", "--scr", "25"]) == 0
    args = ["e2e", "--input", cap, "--profile", "TINY", "--frames", "2", "--win-size", "2"]
    capsys.readouterr()
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    seen = []
    assert tcli.main(args + ["--device", "cpu"], on_result=lambda *a: seen.append(a)) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == {"frames"} and [f["frame"] for f in got["frames"]] == [0, 1]
    assert [f["frame"] for f in want["frames"]] == [0, 1] and [s[0] for s in seen] == [0, 1]
    assert all(s[4] > 0 for s in seen)      # each window's stage time
    for g, w in zip(got["frames"], want["frames"]):
        assert len(g["detections"]) > 0
        cells = {tuple(r[:4]): r[4] for r in g["detections"]}
        want_cells = {tuple(r[:4]): r[4] for r in w["detections"]}
        assert set(cells) == set(want_cells)
        peak = max(want_cells.values())
        for k, a in want_cells.items():
            assert abs(cells[k] - a) <= PEAK_ATOL * peak + RTOL * a, k
        assert {r[0] for r in g["detections"]} == {0, 1}

"""The G0 slice of the port (``cli dmx``) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port.  B3's plain version is held against the Pallas
kernel in interpret mode; the port's G0 chain against the JAX ``G0Chain``
(whose CPU front is the XLA FFT form).  Tolerances:

* RDMs: ``|got - want| <= 5e-5 * peak`` (the JAX package's fused-vs-FFT
  front tolerance, ``tests/test_cli_dmx.py``), or ``2e-5 * peak + 2e-4 *
  |want|`` between the matmul forms: f32 sums in another order;
* CFAR flags: bit for bit, by rerunning each package's CFAR on the RDM the
  port returned (ROADMAP C5: XLA's threaded CPU FFT varies between calls);
* detection lists: valid entries as sets (C4);
* measurements: equal to a few f32 ulps where both packages see the same
  RDM; across packages within one spline step (a near-tie in the f32 spline
  argmax may round the other way) and 1e-3 degrees of elevation.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radar_signal_process_tpu.cli as jcli
from radar_signal_process_tpu.config import G0_PROFILE, G0ChainConfig, NARROW_PULSE_FIR_TAPS
from radar_signal_process_tpu.kernels import pc_rdm_pallas as jpcr
from radar_signal_process_tpu.models.g0_chain import G0Chain as JaxG0Chain
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.ops import measure as jmeasure
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu.ops import pulse_compression as jpc
from radar_signal_process_tpu.ops import spectrum as jspectrum
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu.sim.packets_synth import write_g1_capture
from radar_signal_process_tpu_torch import cli as tcli
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.kernels import pc_rdm as tpcr
from radar_signal_process_tpu_torch.kernels.rdm import dft_planes
from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops import measure as tmeasure
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops import pulse_compression as tpc
from radar_signal_process_tpu_torch.ops import spectrum as tspectrum
from radar_signal_process_tpu_torch.params import g0_chain_params
from tests.test_cli_dmx import _g0_capture
from tests.test_torch_import import as_config

torch.set_num_threads(2)

PROF, CFG = G0_PROFILE, G0ChainConfig()
TPROF, TCFG = as_config(PROF, tconfig), as_config(CFG, tconfig)   # the port's own
FD = -60 * PROF.prf / CFG.mtd_fft_length      # the known-good target: -60 Doppler bins
R_LONG = 100 * PROF.delta_r + CFG.r_sys_err_long - CFG.r_measure_err_long


def _echo(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _f32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _b3_planes(m, window, n_fft, shift=False):
    w_re, w_im = dft_planes(window, n_fft, shift)
    return _f32(m.real), _f32(m.imag), _f32(w_re), _f32(w_im)


def _assert_rdm_close(got, want, atol=2e-5, rtol=2e-4):
    """``|got - want| <= atol * peak + rtol * |want|``."""
    got, want = np.asarray(got), np.asarray(want)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * peak)


def _target_frame(rng, right_gain=0.8):
    """One G0 frame: the known-good target (fd = -60 bins, long cell 100,
    short cell 20), int-rounded at x5000, with a little noise."""
    n = PROF.prt_per_frame
    p_short, p_long = reference_pulses(PROF)
    ramp = np.exp(1j * 2 * np.pi * FD * np.arange(n) * PROF.prt)
    base = np.zeros((n, PROF.point_prt), complex)
    s0, s1 = PROF.segment_starts
    base[:, s0 + 20 : s0 + 20 + len(p_short)] += ramp[:, None] * p_short[None, :]
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    noise = rng.standard_normal((2, n, PROF.point_prt)) * 0.5
    left = np.round(5000 * base.real + noise[0]) + 1j * np.round(5000 * base.imag)
    right = np.round(right_gain * 5000 * base.real + noise[1]) + 1j * np.round(
        right_gain * 5000 * base.imag)
    return left.astype(np.complex64), right.astype(np.complex64)


# ------------------------------------------------------------------- B3 pieces
@pytest.mark.parametrize("n_in,n_fft", [(100, 128), (504, 512), (600, 512)],
                         ids=["short", "g0-long", "truncating"])
def test_pc_matrix_freq_domain_equals_jax(rng, n_in, n_fft):
    spec = np.conj(np.fft.fft(rng.standard_normal(40) + 1j * rng.standard_normal(40), n_fft))
    np.testing.assert_array_equal(tpcr.pc_matrix_freq_domain(spec, n_in, n_fft),
                                  jpcr.pc_matrix_freq_domain(spec, n_in, n_fft))


@pytest.mark.parametrize("n_in", [20, 62])
def test_pc_matrix_fir_equals_jax(n_in):
    taps = np.asarray(NARROW_PULSE_FIR_TAPS)
    np.testing.assert_array_equal(tpcr.pc_matrix_fir(taps, n_in), jpcr.pc_matrix_fir(taps, n_in))


# (batch, n_prt, n_in, PC operator, n_fft); n_fft a multiple of the Pallas tile
B3_GEOMETRIES = {
    "freq-100": (2, 256, 100, ("freq", 128), 512),
    "fir-62": (1, 128, 62, ("fir", None), 256),
    "freq-130": (2, 64, 130, ("freq", 256), 128),
}


def _pc_operator(rng, n_in, kind, pc_fft):
    if kind == "fir":
        return jpcr.pc_matrix_fir(np.asarray(NARROW_PULSE_FIR_TAPS), n_in)
    pulse = rng.standard_normal(24) + 1j * rng.standard_normal(24)
    return jpcr.pc_matrix_freq_domain(np.conj(np.fft.fft(pulse, pc_fft)), n_in, pc_fft)


@pytest.mark.parametrize("case", list(B3_GEOMETRIES))
def test_fused_pc_rdm_plain_matches_pallas(rng, case):
    batch, n_prt, n_in, (kind, pc_fft), n_fft = B3_GEOMETRIES[case]
    echo = _echo(rng, (batch, n_prt, n_in))
    m = _pc_operator(rng, n_in, kind, pc_fft)
    window = np.hamming(n_prt)
    want = np.asarray(jpcr.fused_pc_rdm_pallas(jnp.asarray(echo), m, window, n_fft,
                                               interpret=True))
    got = tpcr.fused_pc_rdm(torch.from_numpy(echo), *_b3_planes(m, window, n_fft))
    assert got.shape == want.shape
    _assert_rdm_close(got, want)


@pytest.mark.parametrize("segment", ["short", "long"])
def test_fused_pc_rdm_plain_matches_pallas_at_g0(rng, segment):
    """Full G0 geometry, both beams; the port reads the segment in place."""
    jc = JaxG0Chain(PROF, CFG, 5, 0)
    params = g0_chain_params(TPROF, TCFG)
    beams = _echo(rng, (2, PROF.prt_per_frame, PROF.point_prt))
    ps = PROF.segment_points[0]
    sl = slice(0, ps) if segment == "short" else slice(ps, None)
    m = jc._pc_matrix_short if segment == "short" else jc._pc_matrix_long
    want = np.asarray(jpcr.fused_pc_rdm_pallas(
        jnp.asarray(np.ascontiguousarray(beams[..., sl])), m, jc._mtd_window,
        CFG.mtd_fft_length, shift=False, interpret=True))
    planes = ((params.pc_short_re, params.pc_short_im) if segment == "short"
              else (params.pc_long_re, params.pc_long_im))
    got = tpcr.fused_pc_rdm(torch.from_numpy(beams)[..., sl], *planes,
                            params.dft_re, params.dft_im)
    assert got.shape == want.shape == (2, CFG.mtd_fft_length, m.shape[1])
    _assert_rdm_close(got, want)


def test_fused_pc_rdm_rejects_mismatched_planes(rng):
    echo = torch.from_numpy(_echo(rng, (2, 16, 10)))
    m = torch.zeros(10, 7)
    w = torch.zeros(32, 16)
    with pytest.raises(ValueError, match="PC planes"):
        tpcr.fused_pc_rdm(echo[..., :9], m, m, w, w)
    with pytest.raises(ValueError, match="DFT planes"):
        tpcr.fused_pc_rdm(echo[:, :15], m, m, w, w)


def test_g0_fir_form_matches_jax(rng):
    """The raw-tap FIR (no normalisation, scale or delay roll) of the G0
    short segment."""
    x = _echo(rng, (8, 62))
    want = np.asarray(jpc.fir_compress(jnp.asarray(x), NARROW_PULSE_FIR_TAPS, normalize=False,
                                       post_scale=1.0, roll_group_delay=False))
    spec = torch.from_numpy(tpc.fir_spectrum(62, normalize=False).astype(np.complex64))
    got = tpc.fir_compress(torch.from_numpy(x), spec, len(NARROW_PULSE_FIR_TAPS),
                           post_scale=1.0, roll_group_delay=False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    # the Toeplitz operator B3 uses computes the same filter
    np.testing.assert_allclose(x @ tpcr.pc_matrix_fir(np.asarray(NARROW_PULSE_FIR_TAPS), 62),
                               want, atol=2e-5 * np.abs(want).max())


def test_g0_pulse_compression_matches_jax_pc(rng):
    """``G0Chain.pc`` (FIR + 512-point matched filter) against the JAX ``_pc``."""
    left, right = _echo(rng, (2, PROF.prt_per_frame, PROF.point_prt))
    want_s, want_l = JaxG0Chain(PROF, CFG, 5, 0)._pc(jnp.asarray(left), jnp.asarray(right))
    chain = G0Chain(TPROF, TCFG, 5, 0, device="cpu")
    got_s, got_l = chain.pc(chain.beams(left, right))
    for got, want in ((got_s, want_s), (got_l, want_l)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5 * np.abs(want).max())


def test_b3_plain_matches_its_cufft_form(rng):
    """B3's plain version against its cuFFT form (``G0Chain.front_fft``) at
    the JAX package's 5e-5 * peak."""
    chain = G0Chain(TPROF, TCFG, 5, 0, device="cpu")
    beams = chain.beams(*_echo(rng, (2, PROF.prt_per_frame, PROF.point_prt)))
    for got, want in zip(chain.front(beams), chain.front_fft(beams)):
        assert got.shape == want.shape
        _assert_rdm_close(got, want, atol=5e-5, rtol=0.0)


# ------------------------------------------------------- notch, measure, width
@pytest.mark.parametrize("n_clutter", [0, 3, 6])
def test_zero_velocity_notch_unshifted_matches_jax(rng, n_clutter):
    rdm = np.abs(rng.standard_normal((2, 64, 9))).astype(np.float32) + 0.5
    want = np.asarray(jmtd.zero_velocity_notch_unshifted(jnp.asarray(rdm), n_clutter))
    got = tmtd.zero_velocity_notch_unshifted(torch.from_numpy(rdm), n_clutter).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, : n_clutter + 1] == 0).all() and (got[:, 64 - n_clutter :] == 0).all()


def _peaked_rdm(rng, nv, nr, cells):
    """Noise floor plus a smooth, clearly peaked blob at each (v, r)."""
    rdm = np.abs(rng.standard_normal((nv, nr))) + 1.0
    vv, rr = np.meshgrid(np.arange(nv), np.arange(nr), indexing="ij")
    for v, r in cells:
        dv = rng.uniform(-0.4, 0.4)
        dr = rng.uniform(-0.4, 0.4)
        rdm += 200.0 * np.exp(-((vv - v - dv) ** 2) / 3.0 - ((rr - r - dr) ** 2) / 2.0)
    return rdm.astype(np.float32)


# (extra_dots, r_interp, v_interp, n_clutter)
MEASURE_CASES = {"g0": (2, 8, 4, 6), "coarse": (2, 4, 2, 0), "wide": (3, 8, 8, 10)}


@pytest.mark.parametrize("case", list(MEASURE_CASES))
def test_motion_parameters_matches_jax(rng, case):
    extra, r_interp, v_interp, n_clutter = MEASURE_CASES[case]
    nv, nr = 128, 48
    # interior peaks, range-edge peaks and peaks beside the clutter rows
    cells = [(40, 20), (70, 0), (90, nr - 1), (n_clutter + 2, 10), (nv - n_clutter - 2, 30),
             (60, 1)]
    rdm = _peaked_rdm(rng, nv, nr, cells)
    diff = (rng.standard_normal((nv, nr)) * 5).astype(np.float32)
    v_idx = np.array([c[0] for c in cells] + [0, 0], np.int32)
    r_idx = np.array([c[1] for c in cells] + [0, 0], np.int32)
    valid = np.array([True] * len(cells) + [False, False])
    amp = rdm[v_idx, r_idx]
    r_scale = np.arange(nr) * 12.0 + 652.0
    v_scale = -0.0319 * np.fft.fftshift(np.arange(-nv // 2, nv // 2) * 150.0) / 2.0
    kw = dict(delta_r=12.0, delta_v=2.4, k_value=10.5, beam_pos=3, beam_angle_step=5.0,
              n_clutter=n_clutter, extra_dots=extra, r_interp=r_interp, v_interp=v_interp,
              ele_angle_comp=0.25, ele_angle_sys_err=-0.5)
    want = jmeasure.motion_parameters(
        jnp.asarray(rdm), jnp.asarray(diff),
        jmeasure.DetectionList(jnp.asarray(v_idx), jnp.asarray(r_idx), jnp.asarray(amp),
                               jnp.asarray(valid)),
        r_scale=r_scale, v_scale=v_scale, **kw)
    got = tmeasure.motion_parameters(
        torch.from_numpy(rdm), torch.from_numpy(diff),
        tmeasure.DetectionList(torch.from_numpy(v_idx), torch.from_numpy(r_idx),
                               torch.from_numpy(amp), torch.from_numpy(valid)),
        r_scale=torch.from_numpy(r_scale.astype(np.float32)),
        v_scale=torch.from_numpy(v_scale.astype(np.float32)), **kw)
    for field in ("range_m", "velocity_ms", "elevation_deg"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=1e-6, atol=0, err_msg=field)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert got.spectral_width is None


def test_spline_eval_matrix_equals_jax():
    for k, u in ((5, 8), (5, 4), (7, 2)):
        np.testing.assert_array_equal(tmeasure.spline_eval_matrix(k, u),
                                      jmeasure.spline_eval_matrix(k, u))


@pytest.mark.parametrize("shifted,interp", [(True, 1), (False, 1), (False, 4)])
def test_detection_spectral_widths_matches_jax(rng, shifted, interp):
    rdm = _peaked_rdm(rng, 64, 16, [(5, 3), (30, 8), (60, 12)])
    r_idx = np.array([3, 8, 12, 0], np.int32)
    want = np.asarray(jspectrum.detection_spectral_widths(
        jnp.asarray(rdm), jnp.asarray(r_idx), -10.0, shifted_input=shifted,
        interp=interp > 1, interp_times=interp))
    got = tspectrum.detection_spectral_widths(
        torch.from_numpy(rdm), torch.from_numpy(r_idx), -10.0, shifted_input=shifted,
        interp=interp > 1, interp_times=interp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got > 0).any()


@pytest.mark.parametrize("interp", [False, True])
def test_amp_constrained_width_matches_jax(rng, interp):
    spec = _echo(rng, (3, 32))
    spec[:, 5] += 20.0
    want = np.asarray(jspectrum.amp_constrained_width(jnp.asarray(spec), -6.0, interp=interp))
    got = tspectrum.amp_constrained_width(torch.from_numpy(spec), -6.0, interp=interp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------- the G0 chain
@pytest.mark.parametrize("waveform", ["lfm", "custom-unnormalised"])
def test_g0_chain_params_equal_jax_attributes(rng, waveform):
    kw = {}
    if waveform != "lfm":
        kw = dict(match_waveform=rng.standard_normal(50) + 1j * rng.standard_normal(50),
                  power_norm=False)
    jc = JaxG0Chain(PROF, CFG, 5, 0, **kw)
    p = g0_chain_params(TPROF, TCFG, **kw)
    f32 = np.float32
    np.testing.assert_array_equal(p.match_spec.numpy(), jc._match_spec.astype(np.complex64))
    np.testing.assert_array_equal(p.pc_long_re.numpy(), jc._pc_matrix_long.real.astype(f32))
    np.testing.assert_array_equal(p.pc_long_im.numpy(), jc._pc_matrix_long.imag.astype(f32))
    np.testing.assert_array_equal(p.pc_short_re.numpy(), jc._pc_matrix_short.real.astype(f32))
    np.testing.assert_array_equal(p.pc_short_im.numpy(), jc._pc_matrix_short.imag.astype(f32))
    np.testing.assert_array_equal(p.mtd_window.numpy(), jc._mtd_window.astype(f32))
    dft = jmtd._dft_matrix_rect(CFG.mtd_fft_length, PROF.prt_per_frame, False,
                                tuple(jc._mtd_window.tolist()))
    np.testing.assert_array_equal(p.dft_re.numpy(), np.asarray(dft).real.astype(f32))
    np.testing.assert_array_equal(p.dft_im.numpy(), np.asarray(dft).imag.astype(f32))
    np.testing.assert_array_equal(p.r_scale_short.numpy(), jc.r_scale_short.astype(f32))
    np.testing.assert_array_equal(p.r_scale_long.numpy(), jc.r_scale_long.astype(f32))


def _valid_cells(dets):
    v, r, ok = (np.asarray(x) for x in (dets.v_idx, dets.r_idx, dets.valid))
    return set(zip(v[ok].tolist(), r[ok].tolist()))


def test_g0_chain_process_frame_matches_jax(rng):
    """One full-width frame through both chains (max 64 detections, so every
    hit of this frame is listed and the sets do not hinge on top-k order)."""
    left, right = _target_frame(rng)
    jc = JaxG0Chain(PROF, CFG, 5, 2, max_detections=64)
    tc = G0Chain(TPROF, TCFG, 5, 2, max_detections=64, device="cpu")
    want = jc.process_frame(left, right)
    got = tc.process_frame(left, right)
    assert tc.n_clutter == jc.n_clutter
    for seg in ("short", "long"):
        w_sum = np.asarray(getattr(want, f"rdm_sum_{seg}"))
        g_sum = getattr(got, f"rdm_sum_{seg}")
        peak = np.abs(w_sum).max()
        np.testing.assert_allclose(g_sum.numpy(), w_sum, rtol=0, atol=5e-5 * peak)
        np.testing.assert_allclose(getattr(got, f"rdm_diff_{seg}").numpy(),
                                   np.asarray(getattr(want, f"rdm_diff_{seg}")),
                                   rtol=0, atol=5e-5 * peak)
        # C5: flags by rerunning each package's CFAR on the port's RDM
        jf, jv = jcfar.cascaded_cfar2d(jnp.asarray(g_sum.numpy()), PROF.cfar, tc.n_clutter)
        np.testing.assert_array_equal(getattr(got, f"flags_{seg}").numpy(), np.asarray(jf))
        np.testing.assert_array_equal(getattr(got, f"vflags_{seg}").numpy(), np.asarray(jv))
        pf, _ = tcfar.cascaded_cfar2d(torch.from_numpy(np.array(w_sum)), TPROF.cfar,
                                      jc.n_clutter)
        np.testing.assert_array_equal(pf.numpy(), np.asarray(getattr(want, f"flags_{seg}")))
        # C4: valid detections as sets
        g_dets, w_dets = getattr(got, f"detections_{seg}"), getattr(want, f"detections_{seg}")
        assert _valid_cells(g_dets) == _valid_cells(w_dets) != set()
        # measurements, matched by cell
        gm, wm = getattr(got, f"measurements_{seg}"), getattr(want, f"measurements_{seg}")
        w_at = {c: i for i, c in enumerate(zip(np.asarray(w_dets.v_idx).tolist(),
                                               np.asarray(w_dets.r_idx).tolist()))}
        for i, c in enumerate(zip(g_dets.v_idx.tolist(), g_dets.r_idx.tolist())):
            if not bool(g_dets.valid[i]):
                continue
            j = w_at[c]
            assert abs(float(gm.range_m[i]) - float(wm.range_m[j])) <= (
                PROF.delta_r / CFG.r_interp_times + 1e-3)
            assert abs(float(gm.velocity_ms[i]) - float(wm.velocity_ms[j])) <= (
                tc.delta_v / CFG.v_interp_times + 1e-4)
            assert abs(float(gm.elevation_deg[i]) - float(wm.elevation_deg[j])) <= 1e-3
    # the strongest long-pulse hit is the target, and both measure it alike
    m, wm = got.measurements_long, want.measurements_long
    v_true = -tc.wavelength * FD / 2.0
    assert abs(float(m.velocity_ms[0]) - v_true) < 0.3 and abs(float(m.range_m[0]) - R_LONG) < (
        2 * PROF.delta_r)
    np.testing.assert_allclose(float(m.range_m[0]), float(wm.range_m[0]), rtol=1e-6)
    np.testing.assert_allclose(float(m.velocity_ms[0]), float(wm.velocity_ms[0]), rtol=1e-6)


def test_g0_chain_per_frame_agility(rng):
    """process_frame(freq_index=, beam_pos=) equals a chain built fixed at
    those values, and the per-frame constants equal the JAX chain's."""
    left, right = _target_frame(rng)
    agile = G0Chain(TPROF, TCFG, freq_index=5, beam_pos=0, device="cpu")
    jax_agile = JaxG0Chain(PROF, CFG, freq_index=5, beam_pos=0)
    for fi, bp in ((0, 1), (10, 3)):
        got = agile.process_frame(left, right, freq_index=fi, beam_pos=bp)
        fixed = G0Chain(TPROF, TCFG, freq_index=fi, beam_pos=bp, device="cpu")
        want = fixed.process_frame(left, right)
        for field in ("range_m", "velocity_ms", "elevation_deg", "valid"):
            assert torch.equal(getattr(got.measurements_long, field),
                               getattr(want.measurements_long, field)), (fi, bp, field)
        assert torch.equal(got.flags_long, want.flags_long)
        assert fixed.k_value != agile.k_value
        (tp, tn), (jp, jn) = agile.frame_params(fi, bp), jax_agile.frame_params(fi, bp)
        assert tn == jn and tp.beam_pos == jp.beam_pos
        assert tp.delta_v == jp.delta_v and tp.k_value == jp.k_value
        np.testing.assert_array_equal(tp.v_scale.numpy(), np.asarray(jp.v_scale, np.float32))


@pytest.mark.parametrize("fi,bp", [(-1, 0), (11, 0), (0, 12), (99, 99)])
def test_g0_chain_rejects_out_of_table_indices(fi, bp):
    chain = G0Chain(TPROF, TCFG, device="cpu")
    with pytest.raises(ValueError, match="calibration tables"):
        chain.frame_params(fi, bp)


# ------------------------------------------------------------------- cli dmx
def _dmx_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_dmx_cli_end_to_end_matches_jax(tmp_path, rng, capsys):
    _g0_capture(tmp_path, rng, FD, 100)
    argv = ["dmx", "--input", str(tmp_path), "--frames", "1", "--freq-index", "5",
            "--beam-pos", "2"]
    got = _dmx_json(tcli.main, argv + ["--device", "cpu"], capsys)["frames"][0]
    want = _dmx_json(jcli.main, argv, capsys)["frames"][0]
    assert abs(got["azimuth_deg"] - (100.0 + 29.01 + 5.9)) < 0.2
    for key in ("frame", "azimuth_deg", "freq_index", "beam_pos"):
        assert got[key] == want[key]
    v_true = -JaxG0Chain(PROF, CFG, 5, 2).wavelength * FD / 2.0
    assert any(abs(v - v_true) < 0.3 for v in got["long"]["velocity_ms"])
    assert any(abs(r - R_LONG) < 2 * PROF.delta_r for r in got["long"]["range_m"])
    for seg in ("short", "long"):
        assert len(got[seg]["range_m"]) == len(want[seg]["range_m"]) > 0
        for key, tol in (("range_m", PROF.delta_r / 8 + 1e-3), ("elevation_deg", 1e-3)):
            np.testing.assert_allclose(sorted(got[seg][key]), sorted(want[seg][key]),
                                       rtol=0, atol=tol, err_msg=f"{seg} {key}")


def test_dmx_cli_freq_hop_capture(tmp_path, capsys):
    """With no --freq-index/--beam-pos the port derives both from each frame's
    header (agile mode), as the JAX CLI does."""
    n = PROF.prt_per_frame
    _, p_long = reference_pulses(PROF)
    ramp = np.exp(1j * 2 * np.pi * FD * np.arange(n) * PROF.prt)
    base = np.zeros((n, PROF.point_prt), complex)
    s1 = PROF.segment_starts[1]
    base[:, s1 + 100 : s1 + 100 + len(p_long)] += ramp[:, None] * p_long[None, :]
    left = np.round(5000.0 * base.real) + 1j * np.round(5000.0 * base.imag)
    right = 0.8 * left
    write_g1_capture(str(tmp_path), np.stack([left, left]), np.stack([right, right]),
                     freq_index=[2, 9], beam_pos=[1, 4])
    out = _dmx_json(tcli.main, ["dmx", "--input", str(tmp_path), "--frames", "2",
                                "--device", "cpu", "--no-native"], capsys)
    assert [f["freq_index"] for f in out["frames"]] == [2, 9]
    assert [f["beam_pos"] for f in out["frames"]] == [1, 4]
    e1 = out["frames"][0]["long"]["elevation_deg"]
    e2 = out["frames"][1]["long"]["elevation_deg"]
    assert e1 and e2
    assert abs(e2[0] - e1[0] - 3 * CFG.beam_angle_step) < 3.0


def test_dmx_cli_spectral_width_matches_jax(tmp_path, rng, capsys):
    _g0_capture(tmp_path, rng, FD, 100)
    argv = ["dmx", "--input", str(tmp_path), "--frames", "1", "--freq-index", "5",
            "--beam-pos", "2", "--spectral-width-db", "-10.0"]
    got = _dmx_json(tcli.main, argv + ["--device", "cpu"], capsys)["frames"][0]["long"]
    want = _dmx_json(jcli.main, argv, capsys)["frames"][0]["long"]
    widths = got["spectral_width_bins"]
    assert len(widths) == len(got["range_m"]) > 0
    assert all(0.0 <= w < CFG.mtd_fft_length / 2 for w in widths)
    assert sorted(widths) == sorted(want["spectral_width_bins"])


def test_port_g1_capture_writer_is_the_reference(tmp_path, rng):
    from radar_signal_process_tpu_torch.sim import write_g1_capture as port_write

    shape = (2, 6, 10)
    left = rng.integers(-9000, 9000, shape) + 1j * rng.integers(-9000, 9000, shape)
    right = rng.integers(-9000, 9000, shape) + 1j * rng.integers(-9000, 9000, shape)
    kw = dict(frames_per_file=1, freq_index=[3, 7], beam_pos=[0, 5], angle_deg=12.5)
    write_g1_capture(str(tmp_path / "ref"), left, right, **kw)
    port_write(str(tmp_path / "port"), left, right, **kw)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert len(names) == 2 and names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


def test_g0_chain_on_a_reduced_profile_matches_jax(rng):
    """A cut G0 geometry (128 PRT, 62 + 120 samples, 256-point MTD) runs the
    same chain code in both packages."""
    prof = dataclasses.replace(PROF, prt_per_frame=128, point_prt=182, segment_points=(62, 120))
    cfg = dataclasses.replace(CFG, pc_fft_length=128, mtd_fft_length=256)
    p_short, p_long = reference_pulses(prof)
    ramp = np.exp(1j * 2 * np.pi * 0.1 * np.arange(128))
    base = np.zeros((128, 182), complex)
    base[:, 10 : 10 + len(p_short)] += ramp[:, None] * p_short[None, :]
    base[:, 62 + 20 : 62 + 20 + len(p_long)] += ramp[:, None] * p_long[None, :]
    noise = _echo(rng, (2, 128, 182)) * np.float32(30.0)
    left = (4000.0 * base + noise[0]).astype(np.complex64)
    right = (3000.0 * base + noise[1]).astype(np.complex64)
    want = JaxG0Chain(prof, cfg, 3, 1).process_frame(left, right)
    got = G0Chain(as_config(prof, tconfig), as_config(cfg, tconfig), 3, 1,
                  device="cpu").process_frame(left, right)
    for seg in ("short", "long"):
        w_sum = np.asarray(getattr(want, f"rdm_sum_{seg}"))
        g_sum = getattr(got, f"rdm_sum_{seg}")
        assert g_sum.shape == w_sum.shape
        np.testing.assert_allclose(g_sum.numpy(), w_sum, rtol=0, atol=5e-5 * np.abs(w_sum).max())
        jf, _ = jcfar.cascaded_cfar2d(jnp.asarray(g_sum.numpy()), prof.cfar,
                                      JaxG0Chain(prof, cfg, 3, 1).n_clutter)
        np.testing.assert_array_equal(getattr(got, f"flags_{seg}").numpy(), np.asarray(jf))
    assert _valid_cells(got.detections_long) == _valid_cells(want.detections_long) != set()

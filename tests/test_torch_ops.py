"""Port ops vs the JAX package's ops: the same numpy inputs through both.

Windows and pulses must be equal; FFT/matmul results agree within the
repo's f32 tolerance (``tests/test_kernels.py``); CFAR flags are
bit-identical.  Inputs are explicit complex64/float32 (conftest enables
x64 in JAX).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu.config import (
    G0_PROFILE,
    G1_PROFILE,
    G2_PROFILE,
    CFARConfig,
)
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.ops import dbf as jdbf
from radar_signal_process_tpu.ops import measure as jmeasure
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu.ops import pulse_compression as jpc
from radar_signal_process_tpu.ops import waveforms as jwave
from radar_signal_process_tpu.ops import windows as jwin
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops import dbf as tdbf
from radar_signal_process_tpu_torch.ops import measure as tmeasure
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops import pulse_compression as tpc
from radar_signal_process_tpu_torch.ops import waveforms as twave
from radar_signal_process_tpu_torch.ops import windows as twin

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3  # the repo's f32 tolerance (tests/test_kernels.py)
SMALL = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    n_channels=2, n_beams=2,
)


def _cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize(
    "kind", ["kaiser", "hamming", "hann", "blackman", "rect", "bohman",
             "nuttall", "parzen"],
)
def test_make_window_equal(kind):
    for n in (1, 16, 332):
        if n == 1 and kind in ("nuttall", "bohman"):
            continue  # (n-1) divides / endpoint writes; same in both packages
        np.testing.assert_array_equal(
            twin.make_window(kind, n, 8.0), jwin.make_window(kind, n, 8.0)
        )


@pytest.mark.parametrize("profile", [G0_PROFILE, G1_PROFILE, G2_PROFILE],
                         ids=["G0", "G1", "G2"])
def test_reference_pulses_equal(profile):
    want = jwave.reference_pulses(profile)
    got = twave.reference_pulses(profile)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_apply_dbf_matches_jax(rng):
    iq = _cplx(rng, (5, 64, 16), 300.0)
    coeffs = _cplx(rng, (13, 16))
    want = np.asarray(jdbf.apply_dbf(jnp.asarray(iq), jnp.asarray(coeffs)))
    got = tdbf.apply_dbf(torch.from_numpy(iq), torch.from_numpy(coeffs)).numpy()
    assert got.shape == (5, 64, 13) and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_load_dbf_coeffs_equal(tmp_path, rng):
    raw = rng.standard_normal((13, 32))
    path = tmp_path / "dbf.txt"
    np.savetxt(path, raw)
    np.testing.assert_array_equal(
        tdbf.load_dbf_coeffs(str(path), 16), jdbf.load_dbf_coeffs(str(path), 16)
    )
    with pytest.raises(ValueError, match="channels"):
        tdbf.load_dbf_coeffs(str(path), 8)


def test_fft_len_is_the_jax_cpu_length():
    for n in list(range(1, 300)) + [3152, 3168, 4095, 4097]:
        got = tpc.fft_len(n)
        assert got == jpc._next_5smooth(n) and got >= n


@pytest.mark.parametrize("pulse_len", [80, 200])
def test_matched_filter_compress_matches_jax(rng, pulse_len):
    echo = _cplx(rng, (6, 300), 100.0)
    pulse = jwave.reference_pulses(G2_PROFILE)[1][:pulse_len]
    want = np.asarray(jpc.matched_filter_compress(jnp.asarray(echo), pulse))
    spec = torch.from_numpy(tpc.matched_filter_spectrum(pulse, 300).astype(np.complex64))
    got = tpc.matched_filter_compress(torch.from_numpy(echo), spec, len(pulse)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fir_compress_matches_jax(rng):
    echo = _cplx(rng, (6, 228), 100.0)
    want = np.asarray(jpc.fir_compress(jnp.asarray(echo)))
    spec = torch.from_numpy(tpc.fir_spectrum(228).astype(np.complex64))
    got = tpc.fir_compress(torch.from_numpy(echo), spec, 35).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("profile", [SMALL, G2_PROFILE], ids=["small", "g2"])
def test_segmented_pulse_compression_matches_jax(rng, profile):
    echo = _cplx(rng, (3, profile.point_prt), 100.0)
    pulses = jwave.reference_pulses(profile)
    want = np.asarray(
        jpc.segmented_pulse_compression(jnp.asarray(echo), profile, pulses)
    )
    spectra, lens = tpc.segment_filters(profile, pulses)
    got = tpc.segmented_pulse_compression(
        torch.from_numpy(echo), profile,
        [torch.from_numpy(s.astype(np.complex64)) for s in spectra], lens,
    ).numpy()
    assert got.shape == want.shape == echo.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,n_fft,shift", [(332, None, True), (48, 64, False), (96, None, False)])
def test_dft_plane_equal(n, n_fft, shift):
    w = jwin.make_window("kaiser", n, 8.0)
    np.testing.assert_array_equal(
        tmtd.dft_plane(w, n_fft, shift),
        jmtd._dft_matrix_rect(n_fft or n, n, shift, tuple(w.tolist())),
    )


@pytest.mark.parametrize("use_matmul", [False, True], ids=["fft", "matmul"])
@pytest.mark.parametrize("shift", [True, False], ids=["shift", "noshift"])
def test_doppler_process_matches_jax(rng, use_matmul, shift):
    pc = _cplx(rng, (2, 48, 70), 10.0)
    w = jwin.make_window("kaiser", 48, 8.0)
    want = np.asarray(jmtd.doppler_process(
        jnp.asarray(pc), w, shift=shift, use_matmul=use_matmul
    ))
    got = tmtd.doppler_process(
        torch.from_numpy(pc), w, shift=shift, use_matmul=use_matmul
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_doppler_process_zero_padded_matches_jax(rng):
    pc = _cplx(rng, (2, 48, 30), 10.0)
    w = jwin.make_window("hamming", 48)
    want = np.asarray(jmtd.doppler_process(jnp.asarray(pc), w, n_fft=64, shift=False))
    got = tmtd.doppler_process(torch.from_numpy(pc), w, n_fft=64, shift=False).numpy()
    assert got.shape == (2, 64, 30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,divisor", [(332, 150), (332, 20), (16, 20), (96, 10)])
def test_zero_velocity_notch_equal(rng, n, divisor):
    rdm = np.abs(rng.standard_normal((2, n, 9))).astype(np.float32)
    want = np.asarray(jmtd.zero_velocity_notch(jnp.asarray(rdm), divisor=divisor))
    got = tmtd.zero_velocity_notch(torch.from_numpy(rdm), divisor=divisor).numpy()
    np.testing.assert_array_equal(got, want)
    lo, hi = tmtd.notch_rows(n, divisor)
    assert (got[:, lo : hi + 1] == 0).all()


def test_notch_rows_g2():
    # the B2 notch at G2 (divisor 150) and the CFAR-stage re-notch (20)
    assert tmtd.notch_rows(332, 150) == (163, 167)
    assert tmtd.notch_rows(332, 20) == (148, 182)
    assert tmtd.notch_rows(332, 0) == (0, -1)


def test_mti_cancel_equal(rng):
    x = _cplx(rng, (2, 40, 5))
    want = np.asarray(jmtd.mti_cancel(jnp.asarray(x), lag=30))
    got = tmtd.mti_cancel(torch.from_numpy(x), lag=30).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("curve_len", [50, 200])
def test_istc_compensate_matches_jax(rng, curve_len):
    echo = _cplx(rng, (3, 128), 10.0)
    curve = rng.uniform(-30, 0, curve_len)
    want = np.asarray(jmtd.istc_compensate(jnp.asarray(echo), curve))
    got = tmtd.istc_compensate(
        torch.from_numpy(echo), torch.from_numpy(tmtd.stc_gain(curve, 128))
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------- CFAR
def _rdm(rng, nv=96, nr=160, hits=8):
    rdm = np.abs(rng.standard_normal((nv, nr))).astype(np.float32) + 0.5
    for _ in range(hits):
        rdm[rng.integers(8, nv - 8), rng.integers(0, nr)] += 40.0
    return rdm


@pytest.mark.parametrize("method", [0, 1], ids=["GO", "SO"])
@pytest.mark.parametrize("axis", [-1, -2])
def test_cfar1d_bit_equal(rng, method, axis):
    data = _rdm(rng)
    want = np.asarray(jcfar.cfar1d(jnp.asarray(data), 5, 7, 5.0, method, axis=axis))
    got = tcfar.cfar1d(torch.from_numpy(data), 5, 7, 5.0, method, dim=axis).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "cfg",
    [CFARConfig(threshold=5.0), CFARConfig(threshold=5.0, range_extend_cells=2),
     CFARConfig(threshold=5.0, range_detect=False),
     CFARConfig(ref_cells=4, guard_cells=3, threshold=3.3, method=1)],
    ids=["default", "E2", "no-range", "SO-r4g3"],
)
def test_cascaded_cfar2d_bit_equal(rng, cfg):
    rdm = np.stack([_rdm(rng) for _ in range(3)])
    rdm[1, 44:53, :] = 0.0                         # notched rows self-flag
    rdm[2, 30, 10:13] = 45.0                       # exact three-way tie
    want_f, want_v = jcfar.cascaded_cfar2d(jnp.asarray(rdm), cfg, 6)
    got_f, got_v = tcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, 6)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f.any()


def test_segmented_cfar_bit_equal_g2_width(rng):
    segs = G2_PROFILE.cfar_segments
    rdm = _rdm(rng, nv=64, nr=3404, hits=60)
    rdm[:, [0, 227, 228, 950, 951, 3403]] += 40.0  # segment-edge columns
    want_f, want_v = jcfar.segmented_cfar(jnp.asarray(rdm), segs, CFARConfig(threshold=5.0), 3)
    got_f, got_v = tcfar.segmented_cfar(torch.from_numpy(rdm), segs, CFARConfig(threshold=5.0), 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def test_extract_detections_matches_jax(rng):
    rdm = np.abs(rng.standard_normal((2, 3, 40, 50))).astype(np.float32)
    flags = rng.random(rdm.shape) < 0.02
    flags[0, 0, 5, :] = True
    rdm[0, 0, 5, :] = 0.0                          # notched row: amp 0, invalid
    rdm[1, 2, 7, 7] = rdm[1, 2, 9, 9] = 3.5        # a tie
    flags[1, 2, 7, 7] = flags[1, 2, 9, 9] = True
    want = jmeasure.extract_detections(jnp.asarray(flags), jnp.asarray(rdm), 16)
    got = tmeasure.extract_detections(torch.from_numpy(flags), torch.from_numpy(rdm), 16)
    assert got.v_idx.dtype == torch.int32 and got.valid.shape == (2, 3, 16)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.amplitude.numpy(), np.asarray(want.amplitude))
    for idx in np.ndindex(2, 3):
        def cells(d):
            v = _np(d.valid)[idx]
            return set(zip(_np(d.v_idx)[idx][v].tolist(), _np(d.r_idx)[idx][v].tolist()))
        assert cells(got) == cells(want)

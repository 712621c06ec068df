"""B1/B2 wrappers of the port against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the JAX op and the Pallas kernel in interpret mode (B2 within
the repo's f32 tolerance, B1 flags bit for bit).  The CUDA kernels
themselves run only on a GPU, in ``test_torch_gpu.py`` (same input classes)
and in ``chip_smoke.py`` at G2 geometry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu.config import G2_PROFILE, CFARConfig
from radar_signal_process_tpu.kernels import cascaded_cfar2d_pallas, doppler_rdm_pallas
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.kernels import rdm as krdm
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops.windows import make_window
from tests.test_torch_gpu import INPUTS, _on_threshold, _rdm, _ties

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3


def _pc(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(window, n_fft=None, shift=True):
    return tuple(torch.from_numpy(p) for p in krdm.dft_planes(window, n_fft, shift))


# ------------------------------------------------------------------------ B2
@pytest.mark.parametrize(
    "n,nr,divisor,kind",
    [(332, 40, 150, "kaiser"), (96, 300, 20, "kaiser"), (48, 64, None, "hamming"),
     (96, 64, 10, "kaiser")],
    ids=["g2-rows", "div20", "no-notch", "wide-notch"],
)
def test_doppler_rdm_plain_matches_pallas(rng, n, nr, divisor, kind):
    pc = _pc(rng, (2, n, nr))
    w = make_window(kind, n, 8.0)
    want = np.asarray(doppler_rdm_pallas(
        jnp.asarray(pc), w, notch_divisor=divisor, interpret=True
    ))
    w_re, w_im = _planes(w)
    got = krdm.doppler_rdm(
        torch.from_numpy(pc), w_re, w_im, tmtd.notch_rows(n, divisor)
    ).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_doppler_rdm_plain_matches_fft_form(rng):
    """The DFT-plane contraction equals the windowed FFT + notch
    (``doppler_process`` + ``zero_velocity_notch``) of both packages."""
    pc = _pc(rng, (3, 332, 50))
    w = make_window("kaiser", 332, 8.0)
    w_re, w_im = _planes(w)
    got = krdm.doppler_rdm(torch.from_numpy(pc), w_re, w_im, tmtd.notch_rows(332, 150))
    fft = tmtd.zero_velocity_notch(tmtd.doppler_process(torch.from_numpy(pc), w), divisor=150)
    jfft = np.asarray(jmtd.zero_velocity_notch(
        jmtd.doppler_process(jnp.asarray(pc), w, use_matmul=False), divisor=150
    ))
    np.testing.assert_allclose(got.numpy(), fft.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), jfft, rtol=RTOL, atol=ATOL)
    assert (got[:, 163:168] == 0).all()


def test_doppler_rdm_zero_padded_plane(rng):
    """Rectangular plane (n_fft > n), unshifted: the JAX FFT form's result."""
    pc = _pc(rng, (2, 48, 30))
    w = make_window("hamming", 48)
    w_re, w_im = _planes(w, n_fft=64, shift=False)
    got = krdm.doppler_rdm(torch.from_numpy(pc), w_re, w_im, (0, -1)).numpy()
    want = np.asarray(jmtd.doppler_process(jnp.asarray(pc), w, n_fft=64, shift=False))
    assert got.shape == (2, 64, 30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_doppler_rdm_cpu_dispatch_and_validation(rng):
    pc = torch.from_numpy(_pc(rng, (2, 16, 20)))
    w_re, w_im = _planes(make_window("kaiser", 16))
    before = krdm.doppler_rdm.launches
    got = krdm.doppler_rdm(pc, w_re, w_im, (6, 8))
    torch.testing.assert_close(
        got, krdm.doppler_rdm_plain(pc, w_re, w_im, (6, 8)), rtol=0, atol=0
    )
    assert krdm.doppler_rdm.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="do not match"):
        krdm.doppler_rdm(pc[:, :15], w_re, w_im, (6, 8))


# ------------------------------------------------------------------------ B1
@pytest.mark.parametrize("case", list(INPUTS))
def test_cascaded_cfar2d_plain_bit_equal(rng, case):
    make, n_clutter, cfg = INPUTS[case]
    rdm = make(rng)
    want_f, want_v = jcfar.cascaded_cfar2d(jnp.asarray(rdm), cfg, n_clutter)
    pal_f, pal_v = cascaded_cfar2d_pallas(jnp.asarray(rdm), cfg, n_clutter, interpret=True)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, n_clutter)
    for got, want in ((got_v, want_v), (got_f, want_f), (got_v, pal_v), (got_f, pal_f)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_f.any()


def test_cascaded_cfar2d_on_threshold_follows_ops_cfar(rng):
    """On the threshold the port follows ``ops.cfar`` (division by float(r)):
    the cell is flagged.  The Pallas kernel's ``* (1/r)`` mean rounds one ulp
    higher and drops it — a fault of that reference kernel (ROADMAP C1); it
    agrees with the port on every other cell."""
    rdm = _on_threshold(rng)
    cfg = CFARConfig(threshold=5.0)
    want_f, want_v = jcfar.cascaded_cfar2d(jnp.asarray(rdm), cfg, 3)
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), cfg, 3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f[30, 30] and got_v[30, 30]
    pal_f, pal_v = (np.asarray(x).copy() for x in cascaded_cfar2d_pallas(
        jnp.asarray(rdm), cfg, 3, interpret=True))
    for got, pal in ((got_f, pal_f), (got_v, pal_v)):
        diff = np.argwhere(got.numpy() != pal)
        assert diff.tolist() in ([], [[30, 30]])


def test_cascaded_cfar2d_segments_cpu_dispatch(rng):
    """With the G2 segment table the wrapper is ``segmented_cfar`` on the CPU."""
    segs = G2_PROFILE.cfar_segments
    rdm = np.stack([_rdm(rng, nv=48, nr=3404, hits=40) for _ in range(2)])
    before = kcfar.cascaded_cfar2d.launches
    got_f, got_v = kcfar.cascaded_cfar2d(torch.from_numpy(rdm), G2_PROFILE.cfar, 2, segs)
    want_f, want_v = jcfar.segmented_cfar(jnp.asarray(rdm), segs, G2_PROFILE.cfar, 2)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert kcfar.cascaded_cfar2d.launches == before


def test_ops_cfar_general_form_matches_ext1_form(rng):
    """The port's two cascade forms (branch-free E=1 and the general
    running-max loop the kernel follows) agree on ties and edges."""
    rdm = torch.from_numpy(_ties(rng))
    cfg = CFARConfig(threshold=5.0)
    f1, _ = tcfar.cascaded_cfar2d(rdm, cfg, 6)
    used = rdm[7:-6]
    rflag = tcfar.cfar1d(used, 5, 7, 5.0, 0, dim=-1)
    vflag = tcfar.cfar1d(used, 5, 7, 5.0, 0, dim=-2)
    # general form with E=1, written out
    best_v = torch.full_like(used, -torch.inf)
    best_o = torch.zeros(used.shape, dtype=torch.int32)
    for d in (-1, 0, 1):
        val = torch.where(tcfar._shift_range(rflag, d, False),
                          tcfar._shift_range(used, d, 0.0), torch.tensor(-torch.inf))
        take = val > best_v
        best_v = torch.where(take, val, best_v)
        best_o = torch.where(take, torch.full_like(best_o, d), best_o)
    win = vflag & (best_v > -torch.inf)
    mark = torch.zeros_like(win)
    for d in (-1, 0, 1):
        mark |= tcfar._shift_range(win & (best_o == d), -d, False)
    assert torch.equal(f1[7:-6], mark)


# --------------------------------------------------------------------- build
def test_build_without_nvcc_raises(monkeypatch):
    """No toolkit: the build fails loudly and leaves no library behind."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    path = _build.library_path()
    if path.exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert not path.exists()


def test_library_path_is_content_addressed():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("librsp_kernels-") and path.suffix == ".so"
    assert path == _build.library_path()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == ["cfar.cu", "rdm.cu"]


def test_wrappers_reject_unsupported_devices(rng):
    pc = torch.from_numpy(_pc(rng, (1, 8, 8))).to("meta")
    w_re, w_im = _planes(make_window("kaiser", 8))
    with pytest.raises(ValueError, match="unsupported device"):
        krdm.doppler_rdm(pc, w_re.to("meta"), w_im.to("meta"), (0, -1))
    with pytest.raises(ValueError, match="unsupported device"):
        kcfar.cascaded_cfar2d(torch.zeros(1, 40, 40, device="meta"), CFARConfig(), 3)

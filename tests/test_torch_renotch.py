"""The CFAR stage's re-notch fused into B1 (``models/detect.py::
renotch_rows`` and ``zero_rows``) against the JAX package.

The JAX ``detect_rdm`` multiplies the RDM by the re-notch mask and runs the
CFAR on the product; the port hands B1 the one run of notched rows inside
the crop instead.  These tests hold the run against the JAX notch, the
port's detectors against the JAX detectors on the same RDMs (flags bit for
bit, detection lists as sets), and pin that the detectors pass B1 the RDM
itself, with no product before it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.models import detect as jdetect
from radar_signal_process_tpu.ops import mtd as jmtd
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.models import detect as tdetect
from tests.test_torch_import import as_config

torch.set_num_threads(2)

# a G2-class (shifted) profile cut to 128 pulses and 344 range cells, its
# three CFAR segments kept; G0 (unshifted, 2048-point FFT) as it is
G2_SMALL = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=128, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_channels=2, n_beams=2,
)
PROFILES = {"g2": (jconfig.G2_PROFILE, 332), "g2-small": (G2_SMALL, 128),
            "g1": (jconfig.G1_PROFILE, 1536),
            "g0": (jconfig.G0_PROFILE, jconfig.G0_PROFILE.mtd.fft_length)}


@pytest.fixture
def rng():
    return np.random.default_rng(20250817)


def _rdm(rng, shape, n_clutter):
    rdm = (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)
    b, nv, nr = shape
    for _ in range(30 * b):
        rdm[rng.integers(0, b), rng.integers(n_clutter + 1, nv - n_clutter), rng.integers(0, nr)] \
            += 40.0
    return rdm


@pytest.mark.parametrize("name", list(PROFILES))
def test_renotch_rows_is_the_masks_zero_run(name):
    """The run is ``renotch_mask``'s zeroed rows inside the crop, and for a
    shifted spectrum the rows the JAX ``zero_velocity_notch(divisor=20)``
    zeroes; G0's unshifted notch lies outside the crop: None."""
    jprof, n_v = PROFILES[name]
    prof = as_config(jprof, tconfig)
    n_clutter = tdetect.clutter_cells(prof, n_v)
    got = tdetect.renotch_rows(prof, n_v, n_clutter, 20)
    mask = tdetect.renotch_mask(prof, n_v, n_clutter, 20)
    crop = np.arange(n_clutter + 1, n_v - n_clutter)
    zero_in_crop = crop[mask[crop] == 0]
    if name == "g0":
        assert got is None and zero_in_crop.size == 0 and (mask == 0).sum() == 2 * n_clutter + 1
        return
    assert got == (zero_in_crop[0], zero_in_crop[-1] + 1)
    assert got[1] - got[0] == zero_in_crop.size
    jzero = np.flatnonzero(np.asarray(jmtd.zero_velocity_notch(
        jnp.ones((n_v, 1), jnp.float32), divisor=20))[:, 0] == 0)
    assert got == (jzero[0], jzero[-1] + 1)
    if name == "g2":
        assert (n_clutter, got) == (14, (148, 183))
    assert tdetect.renotch_rows(prof, n_v, n_clutter, None) is None


def test_renotch_rows_raises_on_two_runs(monkeypatch):
    """A keep-mask with two zeroed runs inside the crop is no one range."""
    prof = tconfig.G2_PROFILE
    mask = np.ones(100, np.float32)
    mask[[20, 21, 40]] = 0.0
    monkeypatch.setattr(tdetect, "renotch_mask", lambda *args: mask)
    tdetect.renotch_rows.cache_clear()
    try:
        with pytest.raises(ValueError, match="not one run"):
            tdetect.renotch_rows(prof, 100, 3, 20)
        mask[40] = 1.0
        assert tdetect.renotch_rows(prof, 100, 3, 20) == (20, 22)
    finally:
        tdetect.renotch_rows.cache_clear()


@pytest.mark.parametrize("n_v", [332, 128, 64, 2048])
def test_sharded_renotch_rows_are_the_jax_notch(n_v):
    """The sharded pipelines hand B1 the rows the JAX sharded pipeline's
    ``zero_velocity_notch(divisor=20)`` zeroes, as one half-open run (B1
    reads only those inside its crop); no divisor, no rows."""
    from radar_signal_process_tpu_torch.parallel import sharding as tsharding

    jzero = np.flatnonzero(np.asarray(jmtd.zero_velocity_notch(
        jnp.ones((n_v, 1), jnp.float32), divisor=20))[:, 0] == 0)
    assert jzero[-1] - jzero[0] + 1 == jzero.size
    assert tsharding._renotch_rows(n_v, 20) == (jzero[0], jzero[-1] + 1)
    assert tsharding._renotch_rows(n_v, None) is None and tsharding._renotch_rows(n_v, 0) is None


@pytest.mark.parametrize("name", ["g2-small", "g0"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_detect_rdm_matches_jax(rng, name, use_pallas):
    """``detect_rdm``: the JAX function's flags bit for bit (its XLA op and
    its per-segment Pallas kernel in interpret mode), the notched rows
    holding data in memory."""
    jprof, n_v = PROFILES[name]
    prof = as_config(jprof, tconfig)
    n_clutter = tdetect.clutter_cells(prof, n_v)
    nr = 344 if name == "g2-small" else 62
    rdm = _rdm(rng, (2, n_v, nr), n_clutter)
    want_f, want_v = jdetect.detect_rdm(jnp.asarray(rdm), jprof, n_clutter, use_pallas=use_pallas)
    got_f, got_v = tdetect.detect_rdm(torch.from_numpy(rdm), prof, n_clutter)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_f.any()


@pytest.mark.parametrize("name", ["g2-small", "g0"])
def test_detector_matches_jax(rng, name):
    """``Detector`` (``make_detector``): the JAX detector's flags and its
    detection list (valid entries as sets: ties, ROADMAP C4)."""
    jprof, n_v = PROFILES[name]
    prof = as_config(jprof, tconfig)
    n_clutter = tdetect.clutter_cells(prof, n_v)
    rdm = _rdm(rng, (2, n_v, 344 if name == "g2-small" else 62), n_clutter)
    want_f, want_v, want_d = jdetect.make_detector(jprof, max_detections=16)(jnp.asarray(rdm))
    got_f, got_v, got_d = tdetect.make_detector(prof, max_detections=16, device="cpu")(
        torch.from_numpy(rdm))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for b in range(2):
        cells = {(int(v), int(r)) for v, r, ok in zip(got_d.v_idx[b], got_d.r_idx[b],
                                                        got_d.valid[b]) if ok}
        want = {(int(v), int(r)) for v, r, ok in zip(np.asarray(want_d.v_idx[b]),
                                                       np.asarray(want_d.r_idx[b]),
                                                       np.asarray(want_d.valid[b])) if ok}
        assert cells == want


def test_detectors_pass_b1_the_rdm_and_its_notched_rows(rng, monkeypatch):
    """No product before B1: ``detect_rdm`` and ``Detector`` hand the RDM
    itself to ``cascaded_cfar2d`` with the G2 re-notch rows (148, 183), and
    nothing else reaches it."""
    calls = []
    real = tdetect.cascaded_cfar2d

    def recording(rdm, cfg, n_clutter, segments=None, zero_rows=None):
        calls.append((rdm, zero_rows))
        return real(rdm, cfg, n_clutter, segments, zero_rows=zero_rows)

    monkeypatch.setattr(tdetect, "cascaded_cfar2d", recording)
    prof = tconfig.G2_PROFILE
    x = torch.from_numpy(_rdm(rng, (1, 332, 400), 14))
    tdetect.detect_rdm(x, dataclasses.replace(prof, cfar_segments=((0, 228), (228, 400))), 14)
    tdetect.make_detector(dataclasses.replace(prof, cfar_segments=((0, 228), (228, 400))),
                          device="cpu")(x)
    assert len(calls) == 2
    assert all(rdm is x and zero == (148, 183) for rdm, zero in calls)

"""The port's native C++ cascade (``kernels/native_cfar.py``) and the split
and cascade detectors of ``models/detect.py`` against the JAX package's.

The native cascade must equal, bit for bit, the JAX native cascade and the
port's split form (``ops.cfar.segmented_cfar_flags`` +
``segmented_cfar_select``, ``transposed=True``) on every input class of
``tests/test_native_cfar.py``.  Without g++ the native tests skip with the
build error as the reason, as the JAX file's do.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu.config import CFARConfig, G2_PROFILE
from radar_signal_process_tpu.kernels import native_cfar as jnative
from radar_signal_process_tpu.models import detect as jdetect
from radar_signal_process_tpu.models import host_parallel as jhp
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.kernels import native_cfar as tnative
from radar_signal_process_tpu_torch.models import detect as tdetect
from radar_signal_process_tpu_torch.models import host_parallel as hp
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar_flags, segmented_cfar_select
from radar_signal_process_tpu_torch.ops.mtd import notch_mask_unshifted, notch_mask
from tests.test_host_parallel import SMALL
from tests.test_torch_import import as_config

torch.set_num_threads(2)


@pytest.fixture
def native():
    if not tnative.native_cfar_available():
        pytest.skip(f"native CFAR unavailable: {tnative.build_error()}")
    if not jnative.native_cfar_available():
        pytest.skip(f"JAX native CFAR unavailable: {jnative.build_error()}")


def _split(rdm_t, segments, cfg, n_clutter, renotch=None, unshifted=False):
    """The port's split form on a transposed RDM, with the re-notch."""
    x = torch.from_numpy(rdm_t)
    n_v = rdm_t.shape[1]
    if renotch:
        keep = notch_mask_unshifted(n_v, n_clutter) if unshifted else notch_mask(n_v, renotch)
        x = x * torch.from_numpy(keep)
    segs = segments or ((0, rdm_t.shape[0]),)
    vf, rf = segmented_cfar_flags(x, segs, cfg, n_clutter, transposed=True)
    f, v = segmented_cfar_select(x, vf, rf, segs, cfg, n_clutter, transposed=True)
    return f.numpy(), v.numpy()


def _check(rdm_t, segments, cfg, n_clutter, renotch=None, unshifted=False):
    if renotch is None:
        mask = None
    elif unshifted:
        mask = tnative.notch_mask_unshifted(rdm_t.shape[1], n_clutter)
    else:
        mask = tnative.notch_mask_shifted(rdm_t.shape[1], renotch)
    tcfg = as_config(cfg, tconfig)
    got_f, got_v = tnative.make_native_cascade(n_clutter, tcfg, segments=segments,
                                               notch_mask=mask)(rdm_t)
    want_f, want_v = jnative.make_native_cascade(n_clutter, cfg, segments=segments,
                                                 notch_mask=mask)(rdm_t)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    split_f, split_v = _split(rdm_t, segments, tcfg, n_clutter, renotch, unshifted)
    np.testing.assert_array_equal(got_v.numpy(), split_v)
    np.testing.assert_array_equal(got_f.numpy(), split_f)
    # a CPU tensor in is the same as the array
    tf, tv = tnative.make_native_cascade(n_clutter, tcfg, segments=segments,
                                         notch_mask=mask)(torch.from_numpy(rdm_t))
    assert torch.equal(tf, got_f) and torch.equal(tv, got_v)


def _ties(rng):
    rdm_t = np.ones((30, 30), np.float32)
    rdm_t[10:20, :] = 7.0
    return rdm_t


# (rdm shape or its maker, segments, cfg, n_clutter, renotch, unshifted):
# the eight input classes of tests/test_native_cfar.py
CASES = {
    "basic": ((96, 48), ((0, 40), (40, 96)), CFARConfig(ref_cells=3, guard_cells=2,
                                                        threshold=3.0), 4, 20, False),
    "notched_zero_rows": ("abs", ((0, 64),), CFARConfig(ref_cells=2, guard_cells=1,
                                                        threshold=5.0), 3, 8, False),
    "so": ((50, 36), ((0, 50),), CFARConfig(ref_cells=4, guard_cells=3, threshold=2.0,
                                            method=1), 2, None, False),
    "no_range": ((50, 36), ((0, 50),), CFARConfig(ref_cells=3, guard_cells=2, threshold=3.0,
                                                  range_detect=False), 2, None, False),
    "general_ext": ((80, 44), ((0, 30), (30, 80)), CFARConfig(
        ref_cells=3, guard_cells=2, threshold=2.5, range_extend_cells=2), 3, 10, False),
    "unshifted_notch": ((60, 64), ((0, 60),), CFARConfig(ref_cells=5, guard_cells=7,
                                                         threshold=4.0), 6, 20, True),
    "short_segments": ((40, 40), ((0, 14), (14, 40)), CFARConfig(ref_cells=5, guard_cells=7,
                                                                 threshold=1.5), 2, 20, False),
    "g2_geometry": ("g2", ((0, 82), (82, 318), (318, 3404)), CFARConfig(threshold=5.0), 14,
                    20, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_cascade_matches_jax_and_split(native, rng, case):
    shape, segments, cfg, n_clutter, renotch, unshifted = CASES[case]
    if shape == "abs":
        rdm_t = np.abs(rng.standard_normal((64, 40))).astype(np.float32)
    elif shape == "g2":      # full G2 geometry, quantized amplitudes: ties
        rdm_t = np.round((rng.standard_normal((3404, 332)).astype(np.float32)) ** 2 * 4) / 4
    else:
        rdm_t = (rng.standard_normal(shape).astype(np.float32)) ** 2
    _check(rdm_t, segments, cfg, n_clutter, renotch, unshifted)


@pytest.mark.parametrize("ext", [1, 2])
def test_native_cascade_ties_first_max_wins(native, rng, ext):
    cfg = CFARConfig(ref_cells=2, guard_cells=1, threshold=1.0, range_extend_cells=ext)
    _check(_ties(rng), ((0, 30),), cfg, n_clutter=2)


def test_native_cascade_random_config_fuzz(native, rng):
    for _ in range(8):
        n_r, n_v = int(rng.integers(30, 200)), int(rng.integers(24, 80))
        n_clutter = int(rng.integers(1, max(2, n_v // 6)))
        cfg = CFARConfig(
            ref_cells=int(rng.integers(1, 6)), guard_cells=int(rng.integers(0, 8)),
            threshold=float(rng.uniform(0.5, 6.0)), method=int(rng.integers(0, 2)),
            range_detect=bool(rng.integers(0, 2)), range_extend_cells=int(rng.integers(1, 4)),
        )
        n_segs = int(rng.integers(1, 4))
        cuts = sorted(rng.choice(np.arange(5, n_r - 5), size=n_segs - 1, replace=False).tolist())
        bounds = [0] + [int(c) for c in cuts] + [n_r]
        segments = tuple((bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1))
        renotch = int(rng.choice([0, 8, 20]))
        rdm_t = (rng.standard_normal((n_r, n_v)).astype(np.float32)) ** 2
        _check(rdm_t, segments, cfg, n_clutter, renotch=renotch or None)


def test_native_cascade_rejects_bad_input(native):
    cfg = tconfig.CFARConfig(ref_cells=2, guard_cells=1, threshold=2.0)
    rdm_t = np.ones((20, 30), np.float32)
    for segs in (((0, 25),), ((-2, 10),), ((10, 10),)):
        with pytest.raises(ValueError, match="segment"):
            tnative.make_native_cascade(2, cfg, segments=segs)(rdm_t)
    with pytest.raises(ValueError, match="2-D"):
        tnative.make_native_cascade(2, cfg)(np.ones((2, 20, 30), np.float32))
    with pytest.raises(ValueError, match="notch mask"):
        tnative.make_native_cascade(2, cfg, notch_mask=np.zeros(7, np.uint8))(rdm_t)


def test_native_cascade_routes_the_cpu_block_stream(native, rng, monkeypatch):
    """The port's CPU block stream runs the native cascade by default (one
    call per RDM), with the outputs of the split form, which runs where the
    native cascade cannot be built."""
    prof = as_config(SMALL, tconfig)
    shape = (prof.n_beams, prof.prt_per_frame, prof.point_prt)
    frames = [torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                               .astype(np.complex64)) for _ in range(3)]
    calls = []
    real = tnative.make_native_cascade

    def counting(*a, **k):
        one = real(*a, **k)
        return lambda r: calls.append(1) or one(r)

    monkeypatch.setattr(tnative, "make_native_cascade", counting)

    def collect():
        run = hp.make_stream_pipeline(prof, 4, 4, max_detections=8, device="cpu")
        got = {}
        run(frames, lambda w, *r: got.__setitem__(w, r))
        return got

    with monkeypatch.context() as m:
        m.setattr(tnative, "native_cfar_available", lambda: False)
        want = collect()
    assert calls == []
    got = collect()
    assert len(calls) == 2 * prof.n_beams * 4
    assert sorted(got) == sorted(want) == [0, 1]
    for w in want:
        assert torch.equal(got[w][0], want[w][0]) and torch.equal(got[w][1], want[w][1])
        assert got[w][3] == want[w][3]
        for a, b in zip(got[w][2], want[w][2]):
            assert torch.equal(a, b)


def test_native_build_failure_falls_back_to_split(monkeypatch, caplog, rng):
    """A native build that fails logs its error at WARNING and the split
    form runs."""
    monkeypatch.setattr(tnative, "native_cfar_available", lambda: False)
    monkeypatch.setattr(tnative, "build_error", lambda: "g++ unavailable: test")
    prof = as_config(SMALL, tconfig)
    with caplog.at_level("WARNING"):
        det = tdetect.make_cascade_detector(prof, 4, transposed=True, prefer_native=True,
                                            device="cpu")
    assert "g++ unavailable: test" in caplog.text
    rdm_t = (rng.standard_normal((2, 344, 32)).astype(np.float32)) ** 2
    want = tdetect.make_split_detector(prof, 4, transposed=True, device="cpu")(
        torch.from_numpy(rdm_t))
    for a, b in zip(det(torch.from_numpy(rdm_t)), want):
        assert torch.equal(a, b)


UNSHIFTED = dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, fftshift=False))


@pytest.mark.parametrize("spectrum", ["shifted", "unshifted"])
@pytest.mark.parametrize("renotch", [20, None], ids=["renotch20", "no_renotch"])
@pytest.mark.parametrize("transposed", [False, True], ids=["standard", "transposed"])
def test_detectors_match_jax(rng, transposed, renotch, spectrum):
    """``make_split_detector`` and ``make_cascade_detector`` (the native
    cascade where the JAX one takes it) against the JAX functions on one
    batch of RDMs: flags and vflags bit for bit."""
    prof = SMALL if spectrum == "shifted" else UNSHIFTED
    rdm = (rng.standard_normal((2, 3, 32, 344)).astype(np.float32)) ** 2
    rdm[..., 5:27, 100] += 30.0
    x = np.ascontiguousarray(np.swapaxes(rdm, -1, -2)) if transposed else rdm
    tprof = as_config(prof, tconfig)
    native_ok = tnative.native_cfar_available() and jnative.native_cfar_available()
    for prefer in ([None, True] if native_ok else [None]):
        if prefer is None:
            want = jdetect.make_split_detector(prof, 4, renotch_divisor=renotch,
                                               transposed=transposed)(jnp.asarray(x))
            got = tdetect.make_split_detector(tprof, 4, renotch_divisor=renotch,
                                              transposed=transposed, device="cpu")(
                torch.from_numpy(x))
        else:
            jdet = jdetect.make_cascade_detector(prof, 4, renotch_divisor=renotch,
                                                 transposed=transposed, prefer_native=True)
            if transposed:   # the JAX native cascade takes one RDM at a time
                outs = [jdet(r) for r in x.reshape(-1, 344, 32)]
                want = tuple(np.stack([o[i] for o in outs]).reshape(x.shape) for i in (0, 1))
            else:
                want = jdet(jnp.asarray(x))
            got = tdetect.make_cascade_detector(tprof, 4, renotch_divisor=renotch,
                                                transposed=transposed, prefer_native=True,
                                                device="cpu")(torch.from_numpy(x))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_flags_is_one_split_detector_call(rng):
    """``make_flags`` equals ``make_cpu_flags`` and the split detector."""
    rdms = (rng.standard_normal((2, 2, 32, 344)).astype(np.float32)) ** 2
    want = jhp.make_cpu_flags(SMALL, 4)(rdms)
    got = hp.make_flags(as_config(SMALL, tconfig), 4, device="cpu")(rdms)
    split = tdetect.make_split_detector(as_config(SMALL, tconfig), 4, device="cpu")(
        torch.from_numpy(rdms))
    for g, w, s in zip(got, want, split):
        np.testing.assert_array_equal(g.numpy(), w)
        assert torch.equal(g, s)


def test_split_detector_clips_segments_to_the_rdm(rng):
    """Profile segments wider than the RDM are clipped as slicing clips
    them (the G2 segments over a narrow test RDM)."""
    prof = dataclasses.replace(G2_PROFILE, prt_per_frame=32)
    rdm = (rng.standard_normal((2, 32, 128)).astype(np.float32)) ** 2
    want = jdetect.make_split_detector(prof, 2)(jnp.asarray(rdm))
    got = tdetect.make_split_detector(as_config(prof, tconfig), 2, device="cpu")(
        torch.from_numpy(rdm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

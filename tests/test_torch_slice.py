"""The G2 streaming slice of the port against the JAX package, end to end.

A capture written by the real ``write_g2_capture`` goes through the JAX
``StreamingPipeline(use_host_parallel=False)`` (the windowed device branch)
and the port's windowed path, ``StreamingPipeline(device="cpu",
use_host_parallel=False)``.  RDM stacks agree within
the repo's f32 tolerance; flags are compared by rerunning each package's
detector on the other's RDMs (CLAUDE.md: FFT outputs differ in the last
bits, the CFAR on a given RDM does not); hit counts are equal; valid
detections are equal as sets (ROADMAP C4).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radar_signal_process_tpu.config import G2_PROFILE
from radar_signal_process_tpu.ingest import G2FrameReader
from radar_signal_process_tpu.models import detect as jdetect
from radar_signal_process_tpu.models import mtd_pipeline as jmtd
from radar_signal_process_tpu.models.streaming import StreamingPipeline as JaxPipeline
from radar_signal_process_tpu.sim.packets_synth import write_g2_capture
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch import ingest as tingest
from radar_signal_process_tpu_torch.models import detect as tdetect
from radar_signal_process_tpu_torch.models import mtd_pipeline as tmtd
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
from tests.test_streaming import SMALL
from tests.test_torch_import import as_config

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3
# tiled CFAR segments over 344 columns (tests/test_streaming.py block tests)
SEGMENTED = dataclasses.replace(
    G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_channels=2, n_beams=2,
)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_rdm_close(got, want):
    """RDMs of int16-scale captures, compared relative to their peak as the
    repo compares FFT chains (tests/test_kernels.py:257-258): f32 FFT error
    scales with the transform's norm, not with each small cell."""
    got, want = _np(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL, atol=2e-5)


def _write(root, profile, n_frames, seed, target_cell=100):
    rng = np.random.default_rng(seed)
    n, pts, ch = profile.prt_per_frame, profile.point_prt, profile.n_channels
    shape = (n_frames, n, pts, ch)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape)
          ).astype(np.complex128)
    # a moving target in the last channel, phase-continuous across frames
    m = np.arange(n_frames * n).reshape(n_frames, n)
    iq[:, :, target_cell, -1] += 20000.0 * np.exp(1j * 2 * np.pi * 0.25 * m)
    write_g2_capture(str(root), iq, profile, data_type=1)
    return str(root)


def test_port_capture_writer_is_the_reference(tmp_path):
    """``radar_signal_process_tpu_torch.sim`` writes byte-identical files."""
    from radar_signal_process_tpu_torch.sim import write_g2_capture as port_write

    rng = np.random.default_rng(3)
    shape = (2, SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape))
    write_g2_capture(str(tmp_path / "ref"), iq, SMALL, data_type=1)
    port_write(str(tmp_path / "port"), iq, as_config(SMALL, tconfig), data_type=1)
    ref = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert ref and ref == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in ref:
        assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()


def _coeffs(profile, seed=5):
    rng = np.random.default_rng(seed)
    shape = (profile.n_beams, profile.n_channels)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _jax_run(cap, profile, n_frames, dbf, **kw):
    pipe = JaxPipeline(
        G2FrameReader(cap, profile), profile, max_frames=n_frames,
        dbf_coeffs=_coeffs(profile) if dbf else None, use_host_parallel=False, **kw,
    )
    return list(pipe), pipe.counters.snapshot()


def _torch_run(cap, profile, n_frames, dbf, **kw):
    profile = as_config(profile, tconfig)
    pipe = StreamingPipeline(
        tingest.G2FrameReader(cap, profile), profile, max_frames=n_frames,
        dbf_coeffs=_coeffs(profile) if dbf else None, device="cpu", use_host_parallel=False,
        **kw,
    )
    return list(pipe), pipe.counters.snapshot()


def _det_cells(dets, idx):
    valid = _np(dets.valid)[idx]
    return set(zip(_np(dets.v_idx)[idx][valid].tolist(), _np(dets.r_idx)[idx][valid].tolist()))


def _assert_same_detections(got, want):
    batch = _np(want.valid).shape[:-1]
    for idx in np.ndindex(*batch):
        assert _det_cells(got, idx) == _det_cells(want, idx), idx


SMALL_KW = dict(win_size=2, clutter_v=1e-6, max_detections=8)
_JAX_CACHE = {}


@pytest.fixture(scope="module")
def small_capture(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("small_cap"), SMALL, 4, seed=11)


def _jax_small(cap, dbf):
    if dbf not in _JAX_CACHE:
        _JAX_CACHE[dbf] = _jax_run(cap, SMALL, 4, dbf, **SMALL_KW)
    return _JAX_CACHE[dbf]


@pytest.mark.parametrize("emit", ["full", "flags", "detections"])
@pytest.mark.parametrize("dbf", [False, True], ids=["channels", "dbf"])
def test_stream_matches_jax(small_capture, dbf, emit):
    want, want_c = _jax_small(small_capture, dbf)
    got, got_c = _torch_run(small_capture, SMALL, 4, dbf, emit=emit, **SMALL_KW)
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert g.cfar_hits == w.cfar_hits
        _assert_same_detections(g.detections, w.detections)
        if emit == "detections":
            assert g.rdms is None and g.flags is None
        elif emit == "flags":
            assert g.rdms is None
            np.testing.assert_array_equal(g.flags.numpy(), np.asarray(w.flags))
        else:
            assert g.rdms.shape == (SMALL.n_beams, 2, 16, 128)
            _assert_rdm_close(g.rdms, w.rdms)
    for key in ("frames_ingested", "windows_processed", "cfar_hits", "prts_parsed"):
        assert got_c[key] == want_c[key], key


@pytest.mark.parametrize("dbf", [False, True], ids=["channels", "dbf"])
def test_stream_flags_cross_detectors(small_capture, dbf):
    """Each package's detector on the other's RDMs gives the other's flags."""
    want, _ = _jax_small(small_capture, dbf)
    got, _ = _torch_run(small_capture, SMALL, 4, dbf, **SMALL_KW)
    n_clutter = jdetect.clutter_cells(SMALL, 16, 1e-6)
    j_det = jdetect.make_detector(SMALL, n_clutter=n_clutter, max_detections=8)
    t_det = tdetect.make_detector(as_config(SMALL, tconfig), n_clutter=n_clutter,
                                  max_detections=8, device="cpu")
    for g, w in zip(got, want):
        t_flags, _, _ = t_det(torch.from_numpy(np.array(w.rdms, np.float32)))
        np.testing.assert_array_equal(t_flags.numpy(), np.asarray(w.flags))
        j_flags, _, _ = j_det(jnp.asarray(g.rdms.numpy()))
        np.testing.assert_array_equal(np.asarray(j_flags), g.flags.numpy())


def test_stream_full_g2_fast_time_single_beam(tmp_path):
    """One beam at the full G2 fast-time width (3404 samples, segments
    228/723/2453, CFAR segments of 228/723/2453 columns), win_size 4."""
    prof = dataclasses.replace(G2_PROFILE, prt_per_frame=48, n_beams=1, n_channels=1)
    cap = _write(tmp_path, prof, 3, seed=12, target_cell=1004)
    kw = dict(win_size=4, max_detections=16)
    want, want_c = _jax_run(cap, prof, 3, False, **kw)
    got, got_c = _torch_run(cap, prof, 3, False, **kw)
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want] == [0, 1]
    tprof = as_config(prof, tconfig)
    n_clutter = tdetect.clutter_cells(tprof, 48)
    t_det = tdetect.make_detector(tprof, n_clutter=n_clutter, max_detections=16, device="cpu")
    for g, w in zip(got, want):
        assert g.rdms.shape == (1, 4, 48, 3404)
        _assert_rdm_close(g.rdms, w.rdms)
        t_flags, _, _ = t_det(torch.from_numpy(np.array(w.rdms, np.float32)))
        np.testing.assert_array_equal(t_flags.numpy(), np.asarray(w.flags))
        assert g.cfar_hits == w.cfar_hits
        _assert_same_detections(g.detections, w.detections)
    assert got_c["cfar_hits"] == want_c["cfar_hits"]


@pytest.mark.parametrize("variant", ["plain", "istc", "mti"])
def test_frame_processor_matches_jax(rng, variant):
    prof, stc = SMALL, None
    if variant == "istc":
        prof = dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, istc=True))
        stc = rng.uniform(-20.0, 0.0, 100)
    elif variant == "mti":
        prof = dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, mti_lag=4))
    shape = (2, 16, 128)
    a, b = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(2))
    want = np.asarray(jmtd.make_frame_processor(prof, 2, stc_curve_db=stc)(
        jnp.asarray(a), jnp.asarray(b)))
    proc = tmtd.make_frame_processor(as_config(prof, tconfig), 2, stc_curve_db=stc, device="cpu")
    got = proc(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape == (2, 2, 16, 128)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert {"window", "dft_re", "dft_im", "pc_spectrum_0"} <= set(dict(proc.named_buffers()))


def test_detector_matches_jax_on_same_rdm(rng):
    rdm = np.abs(rng.standard_normal((2, 3, 32, 344))).astype(np.float32) + 0.5
    for _ in range(30):
        rdm[rng.integers(0, 2), rng.integers(0, 3), rng.integers(4, 28),
            rng.integers(0, 344)] += 40.0
    rdm[..., [0, 23, 24, 103, 104, 343]] += 40.0   # segment-edge columns
    want_f, want_v, want_d = jdetect.make_detector(SEGMENTED, n_clutter=2, max_detections=8)(
        jnp.asarray(rdm))
    det = tdetect.make_detector(as_config(SEGMENTED, tconfig), n_clutter=2, max_detections=8,
                                device="cpu")
    got_f, got_v, got_d = det(torch.from_numpy(rdm))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_d.amplitude.numpy(), np.asarray(want_d.amplitude))
    _assert_same_detections(got_d, want_d)
    # the re-notch is fused into B1 (renotch_rows): no mask buffer is kept
    assert not dict(det.named_buffers())
    assert tdetect.renotch_rows(det.profile, 32, 2, det.renotch_divisor) == (13, 18)


def test_stream_truncated_capture_stops_cleanly(tmp_path):
    cap = _write(tmp_path, SMALL, 3, seed=13)
    p = tmp_path / "1.000001.bin"
    blob = p.read_bytes()
    p.write_bytes(blob[: len(blob) * 3 // 4])      # chop inside frame 3
    got, counters = _torch_run(cap, SMALL, 10, False, **SMALL_KW)
    assert [r.frame_idx for r in got] == [0]
    assert counters["frames_ingested"] == 2


def test_stream_producer_error_surfaces(tmp_path):
    cap = _write(tmp_path, SMALL, 4, seed=14)

    class FailingReader(tingest.G2FrameReader):
        def read_frame(self, idx):
            if idx == 3:
                raise OSError("disk gone")
            return super().read_frame(idx)

    small = as_config(SMALL, tconfig)
    pipe = StreamingPipeline(FailingReader(cap, small), small, max_frames=4,
                             device="cpu", **SMALL_KW)
    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for r in pipe:
            seen.append(r.frame_idx)
    assert seen == [0, 1]


def test_stream_skips_gaps(rng):
    """A non-consecutive frame starts a new pair, as in the JAX windowed
    iterator."""
    pipe = StreamingPipeline(None, as_config(SMALL, tconfig), max_frames=100, device="cpu",
                             **SMALL_KW)
    shape = (SMALL.prt_per_frame, SMALL.point_prt, SMALL.n_channels)

    def fake_produce():
        for idx in (0, 1, 2, 5, 6):
            pipe._queue.put((idx, torch.from_numpy(
                (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                .astype(np.complex64))))

    pipe._produce_inner = fake_produce
    assert [r.frame_idx for r in pipe] == [0, 1, 5]


def test_stream_validation():
    small = as_config(SMALL, tconfig)
    with pytest.raises(ValueError, match="emit"):
        StreamingPipeline(None, small, emit="rdm", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            StreamingPipeline(None, small, device="cuda")


def test_cli_stream_cpu_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``cli stream`` of both packages over one capture.  The shared profile
    table's G2 entry is narrowed for the test, to a geometry above the CFAR
    parity floor on both axes (ROADMAP C3): the JAX CLI takes its CPU
    host-parallel path, whose padded-form CFAR differs from the roll form
    below it."""
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu.config import PROFILES
    from radar_signal_process_tpu_torch import cli as tcli

    prof = dataclasses.replace(
        G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(40, 80, 224),
        cfar_segments=((0, 40), (40, 120), (120, 344)), n_channels=2, n_beams=2,
    )
    monkeypatch.setitem(PROFILES, "G2", prof)
    monkeypatch.setitem(tconfig.PROFILES, "G2", as_config(prof, tconfig))
    cap = _write(tmp_path / "cap", prof, 4, seed=15)
    coeff_path = tmp_path / "dbf.txt"
    c = _coeffs(prof)
    inter = np.empty((prof.n_beams, 2 * prof.n_channels))
    inter[:, 0::2], inter[:, 1::2] = c.real, c.imag
    np.savetxt(coeff_path, inter)
    args = ["stream", "--input", cap, "--frames", "4", "--win-size", "2",
            "--clutter-v", "0.5", "--max-detections", "8",
            "--dbf-coeffs", str(coeff_path), "--emit", "detections", "--no-native"]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seen = []
    assert tcli.main(args + ["--device", "cpu"], on_result=seen.append) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want) == {"frames", "counters"}
    assert [r.frame_idx for r in seen] == [0, 1, 2]
    for g, w in zip(got["frames"], want["frames"]):
        assert set(g) == set(w)
        for key in ("frame", "cfar_hits", "detections_per_beam"):
            assert g[key] == w[key], key
    for key in ("frames_ingested", "windows_processed", "cfar_hits"):
        assert got["counters"][key] == want["counters"][key]

"""The port's block-pipelined stream (``models/host_parallel.py``, the block
path of ``StreamingPipeline`` and the CLI's CPU routes) against the JAX
package's host-parallel CPU chain.

Both packages get the same seeded numpy frames at the ``SMALL`` geometry of
``tests/test_host_parallel.py`` (3 beams, 32 PRT, 344 points).  Tolerances:
RDMs ``rtol 2e-4``, ``atol 2e-3`` (``tests/test_torch_slice.py``; on int16
captures relative to the peak); flags bit for bit against the JAX
``ops.cfar`` split form on the port's RDMs; detection lists equal on valid
entries, as sets (ROADMAP C4); hit counts equal.
"""

import dataclasses
import json
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radar_signal_process_tpu.cli as jcli
from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.config import CFARConfig, G2_PROFILE, MTDConfig
from radar_signal_process_tpu.ingest import G2FrameReader as JReader
from radar_signal_process_tpu.models import host_parallel as jhp
from radar_signal_process_tpu.models import mtd_pipeline as jmtd
from radar_signal_process_tpu.models.detect import make_split_detector as jsplit
from radar_signal_process_tpu.models.streaming import StreamingPipeline as JaxPipeline
from radar_signal_process_tpu.sim.packets_synth import write_g2_capture
from radar_signal_process_tpu_torch import cli as tcli
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.ingest import G2FrameReader
from radar_signal_process_tpu_torch.models import host_parallel as hp
from radar_signal_process_tpu_torch.models import mtd_pipeline as tmtd
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
from radar_signal_process_tpu_torch.utils import load_frame as tload_frame
from radar_signal_process_tpu.utils import load_frame as jload_frame
from tests.test_host_parallel import SMALL
from tests.test_torch_import import as_config

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3
N_CLUTTER = 4
STC = np.linspace(-12.0, 0.0, 200)
VARIANTS = {
    "w4": (SMALL, 4, None),
    "w2": (SMALL, 2, None),
    "mti": (dataclasses.replace(SMALL, mtd=MTDConfig(mti_lag=3)), 4, None),
    "istc": (dataclasses.replace(SMALL, mtd=dataclasses.replace(SMALL.mtd, istc=True)), 2, STC),
}
_CACHE: dict = {}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _frames(n, seed=3, prof=SMALL):
    rng = np.random.default_rng(seed)
    shape = (prof.n_beams, prof.prt_per_frame, prof.point_prt)
    return [(rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
            for _ in range(n)]


def _det_cells(dets, idx):
    valid = _np(dets.valid)[idx]
    return set(zip(_np(dets.v_idx)[idx][valid].tolist(), _np(dets.r_idx)[idx][valid].tolist()))


def _assert_same_detections(got, want):
    for idx in np.ndindex(*_np(want.valid).shape[:-1]):
        assert _det_cells(got, idx) == _det_cells(want, idx), idx


def _jax_flags(prof, rdms, n_clutter=N_CLUTTER):
    """The JAX split-form flags (``ops.cfar``) on the port's RDMs."""
    return np.asarray(jsplit(prof, n_clutter)(jnp.asarray(_np(rdms)))[0])


def _jax_pipeline(variant):
    key = ("jax", variant)
    if key not in _CACHE:
        prof, win, stc = VARIANTS[variant]
        run = jhp.make_cpu_stream_pipeline(prof, win, N_CLUTTER, max_detections=8,
                                           stc_curve_db=stc)
        got = {}
        run([jnp.asarray(f) for f in _frames(4)], lambda w, *r: got.__setitem__(w, r))
        _CACHE[key] = got
    return _CACHE[key]


def _port_pipeline(variant, emit="full", frames=None):
    prof, win, stc = VARIANTS[variant]
    run = hp.make_stream_pipeline(as_config(prof, tconfig), win, N_CLUTTER, max_detections=8,
                                  stc_curve_db=stc, emit=emit, device="cpu")
    got, order = {}, []

    def emit_cb(w, *r):
        order.append(w)
        got[w] = r

    frames = frames or [torch.from_numpy(f) for f in _frames(4)]
    last = run(frames, emit_cb)
    assert order == [0, 1, 2]
    return got, last


@pytest.mark.parametrize("emit", hp.EMIT_MODES)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_stream_pipeline_matches_jax(variant, emit):
    """win_size 2 and 4, MTI and the iSTC hook, every emit mode: the block
    runner's windows in order against ``make_cpu_stream_pipeline``."""
    prof = VARIANTS[variant][0]
    want = _jax_pipeline(variant)
    if ("port", variant) not in _CACHE:
        _CACHE["port", variant] = _port_pipeline(variant)[0]
    full = _CACHE["port", variant]
    got = full if emit == "full" else _port_pipeline(variant, emit)[0]
    for w in range(3):
        (rdms, flags, dets, hits), (f_rdms, f_flags, _, _) = got[w], full[w]
        w_rdms, w_flags, w_dets, w_hits = want[w]
        np.testing.assert_allclose(_np(f_rdms), w_rdms, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(_np(f_flags), _jax_flags(prof, f_rdms))
        assert hits == w_hits == int(f_flags.sum())
        _assert_same_detections(dets, w_dets)
        assert (rdms is None) == (emit != "full")
        assert (flags is None) == (emit == "detections")
        if flags is not None:
            np.testing.assert_array_equal(_np(flags), _np(f_flags))


def test_stream_pipeline_live_ingest_and_release():
    """Later frames may be callables; each raw frame is released once
    compressed; a callable ``frames[0]`` raises; ``emit_cb``'s error
    re-raises."""
    frames = _frames(4)
    want, want_last = _port_pipeline("w4")
    made = []

    def getter(f):
        def get():
            t = torch.from_numpy(f.copy())
            made.append(weakref.ref(t))
            return t
        return get

    alive = []
    run = hp.make_stream_pipeline(as_config(SMALL, tconfig), 4, N_CLUTTER, max_detections=8,
                                  device="cpu")
    got = {}

    def emit_cb(w, *r):
        alive.append(sum(ref() is not None for ref in made))
        got[w] = r

    last = run([torch.from_numpy(frames[0])] + [getter(f) for f in frames[1:]], emit_cb)
    assert len(made) == 3 and alive == [0, 0, 0]
    assert torch.equal(last, want_last)
    for w in range(3):
        assert torch.equal(got[w][0], want[w][0]) and torch.equal(got[w][1], want[w][1])
    with pytest.raises(ValueError, match="frames\\[0\\]"):
        run([getter(f) for f in frames], emit_cb)

    def boom(w, *r):
        raise RuntimeError("emit failed")

    with pytest.raises(RuntimeError, match="emit failed"):
        run([torch.from_numpy(f) for f in frames], boom)


def test_stream_pipeline_carry_compresses_each_frame_once(monkeypatch):
    """Two blocks joined by the returned carry equal one block, and the
    carried frame is not compressed again."""
    calls = []
    real = hp.segmented_pulse_compression
    monkeypatch.setattr(hp, "segmented_pulse_compression",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    frames = [torch.from_numpy(f) for f in _frames(5)]
    run = hp.make_stream_pipeline(as_config(SMALL, tconfig), 4, N_CLUTTER, max_detections=8,
                                  device="cpu")
    one, two = {}, {}
    run(frames, lambda w, *r: one.__setitem__(w, r))
    assert len(calls) == 5
    calls.clear()
    last = run(frames[:3], lambda w, *r: two.__setitem__(w, r))
    run(frames[2:], lambda w, *r: two.__setitem__(w + 2, r), carry=last)
    assert len(calls) == 5 and sorted(two) == [0, 1, 2, 3]
    for w in range(4):
        assert torch.equal(one[w][0], two[w][0]) and torch.equal(one[w][1], two[w][1])


@pytest.mark.parametrize("variant", ["w2", "mti"])
def test_stream_processor_matches_jax(variant, monkeypatch):
    """Over consecutive ``frame_idx`` each frame is compressed once (PC calls
    = pairs + 1); a frame that differs beyond its leading samples under the
    same index is compressed again."""
    prof, win, _ = VARIANTS[variant]
    calls = []
    real = hp.segmented_pulse_compression
    monkeypatch.setattr(hp, "segmented_pulse_compression",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    frames = _frames(5, seed=4)
    jproc = jhp.make_cpu_stream_processor(prof, win_size=win)
    proc = hp.make_stream_processor(as_config(prof, tconfig), win, device="cpu")
    t = [torch.from_numpy(f) for f in frames]
    for w in range(3):
        got = proc(t[w], t[w + 1], frame_idx=w)
        want = jproc(jnp.asarray(frames[w]), jnp.asarray(frames[w + 1]), frame_idx=w)
        assert got.shape == (prof.n_beams, win, prof.prt_per_frame, prof.point_prt)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert len(calls) == 4
    bad = frames[4].copy()
    bad[:1, :4, :16] = frames[3][:1, :4, :16]       # the leading corner agrees
    got = proc(torch.from_numpy(bad), t[0], frame_idx=3)
    assert len(calls) == 6
    want = jhp.make_cpu_stream_processor(prof, win_size=win)(jnp.asarray(bad),
                                                             jnp.asarray(frames[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_stream_detector_matches_jax():
    frames = _frames(3, seed=5)
    jdet = jhp.make_cpu_stream_detector(SMALL, 4, N_CLUTTER, max_detections=8)
    det = hp.make_stream_detector(as_config(SMALL, tconfig), 4, N_CLUTTER, max_detections=8,
                                  device="cpu")
    for w in range(2):
        rdms, flags, dets = det(torch.from_numpy(frames[w]), torch.from_numpy(frames[w + 1]),
                                frame_idx=w)
        w_rdms, w_flags, w_dets = jdet(frames[w], frames[w + 1], frame_idx=w)
        np.testing.assert_allclose(rdms.numpy(), w_rdms, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(flags.numpy(), _jax_flags(SMALL, rdms))
        np.testing.assert_array_equal(flags.numpy(), w_flags)
        _assert_same_detections(dets, w_dets)


@pytest.mark.parametrize("as_numpy", [True, False], ids=["numpy", "tensor"])
def test_make_flags_matches_jax(rng, as_numpy):
    rdms = (rng.standard_normal((3, 4, 32, 344)).astype(np.float32)) ** 2
    cfg = CFARConfig(ref_cells=3, guard_cells=4, threshold=4.0)
    want_f, want_v = jhp.make_cpu_flags(SMALL, N_CLUTTER, cfg=cfg)(rdms)
    fn = hp.make_flags(as_config(SMALL, tconfig), N_CLUTTER, cfg=as_config(cfg, tconfig),
                       device="cpu")
    got_f, got_v = fn(rdms if as_numpy else torch.from_numpy(rdms))
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("variant", ["w4", "mti"])
def test_frame_processor_matches_cpu_frame_processor(variant):
    """``make_cpu_frame_processor``'s port is ``FrameProcessor``."""
    prof, win, _ = VARIANTS[variant]
    a, b = _frames(2, seed=6, prof=prof)
    want = jhp.make_cpu_frame_processor(prof, win)(a, b)
    got = tmtd.make_frame_processor(as_config(prof, tconfig), win, device="cpu")(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_process_frame_pair_matches_jax():
    frames = np.stack(_frames(2, seed=7))
    want = np.asarray(jmtd.process_frame_pair(jnp.asarray(frames), SMALL, 2))
    got = tmtd.process_frame_pair(torch.from_numpy(frames), as_config(SMALL, tconfig), 2)
    assert got.shape == want.shape == (3, 2, 32, 344)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- StreamingPipeline
BLOCK = dataclasses.replace(
    G2_PROFILE, prt_per_frame=32, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_channels=2, n_beams=2,
)
TINY = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    n_channels=2, n_beams=2,
)


def _capture(root, prof, n_frames, seed, amp=1500, target=None):
    rng = np.random.default_rng(seed)
    shape = (n_frames, prof.prt_per_frame, prof.point_prt, prof.n_channels)
    iq = (rng.integers(-amp, amp, shape) + 1j * rng.integers(-amp, amp, shape)).astype(
        np.complex64)
    if target is not None:
        iq[:, :, target, :] += 15000.0
    write_g2_capture(str(root), iq, prof, data_type=1)
    return str(root)


def _port_stream(cap, prof, n_frames, **kw):
    prof = as_config(prof, tconfig)
    pipe = StreamingPipeline(G2FrameReader(cap, prof), prof, win_size=2, max_frames=n_frames,
                             device="cpu", **kw)
    return list(pipe), pipe


def test_block_path_is_the_cpu_default(tmp_path):
    cap = _capture(tmp_path, BLOCK, 3, seed=8)
    prof = as_config(BLOCK, tconfig)
    assert StreamingPipeline(G2FrameReader(cap, prof), prof, device="cpu")._block_runner
    assert StreamingPipeline(G2FrameReader(cap, prof), prof, device="cpu",
                             use_host_parallel=False)._block_runner is None
    with pytest.raises(ValueError, match="block_windows"):
        StreamingPipeline(None, prof, block_windows=0, device="cpu")


def test_blocks_of_two_equal_one_block_and_jax(tmp_path):
    """Blocks of 2 windows (3 blocks, carries between them) equal one block
    of 5, and both equal the JAX ``StreamingPipeline`` (its CPU block path)
    on the same capture."""
    cap = _capture(tmp_path, BLOCK, 6, seed=9)
    small, _ = _port_stream(cap, BLOCK, 6, block_windows=2)
    big, _ = _port_stream(cap, BLOCK, 6, block_windows=10)
    jpipe = JaxPipeline(JReader(cap, BLOCK), BLOCK, win_size=2, max_frames=6, block_windows=2)
    want = list(jpipe)
    assert [r.frame_idx for r in small] == [r.frame_idx for r in big] == [
        r.frame_idx for r in want] == [0, 1, 2, 3, 4]
    for s, b, w in zip(small, big, want):
        assert torch.equal(s.rdms, b.rdms) and torch.equal(s.flags, b.flags)
        scale = np.abs(np.asarray(w.rdms)).max()
        np.testing.assert_allclose(s.rdms.numpy() / scale, np.asarray(w.rdms) / scale,
                                   rtol=RTOL, atol=2e-5)
        assert s.cfar_hits == b.cfar_hits == w.cfar_hits
        _assert_same_detections(s.detections, w.detections)


def test_gap_closes_the_block(rng):
    """A non-consecutive frame closes the block (its windows still run) and
    starts the next one, compressed anew."""
    prof = as_config(BLOCK, tconfig)
    pipe = StreamingPipeline(None, prof, win_size=2, max_frames=100, device="cpu",
                             clutter_v=1e-6)
    shape = (prof.prt_per_frame, prof.point_prt, prof.n_channels)
    seq = {i: torch.from_numpy((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                               .astype(np.complex64)) for i in (0, 1, 2, 5, 6)}

    def fake_produce():
        for idx, f in seq.items():
            pipe._queue.put((idx, f))

    pipe._produce_inner = fake_produce
    got = list(pipe)
    assert [r.frame_idx for r in got] == [0, 1, 5]
    fp = tmtd.make_frame_processor(prof, 2, device="cpu")
    for r in got:
        want = fp(seq[r.frame_idx].permute(2, 0, 1), seq[r.frame_idx + 1].permute(2, 0, 1))
        np.testing.assert_allclose(r.rdms.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_block_soak_long_capture(tmp_path):
    """51 frames in blocks of 6 (9 blocks): windows in order, at most two
    blocks' stacks alive at once, consistent counters."""
    n_frames, k = 51, 6
    cap = _capture(tmp_path, TINY, n_frames, seed=10, amp=300, target=40)
    prof = as_config(TINY, tconfig)
    pipe = StreamingPipeline(G2FrameReader(cap, prof), prof, win_size=2, max_frames=n_frames,
                             clutter_v=1e-6, max_detections=8, block_windows=k, device="cpu")
    seen, hits, blocks, peak = [], 0, [], 0
    for r in pipe:
        seen.append(r.frame_idx)
        hits += r.cfar_hits
        assert r.rdms.shape == (2, 2, 16, 128)
        base = r.rdms.untyped_storage()        # the block's RDM stack
        if not any(ref() is base for ref in blocks):
            blocks.append(weakref.ref(base))
        del base, r
        peak = max(peak, sum(ref() is not None for ref in blocks))
    assert seen == list(range(n_frames - 1))
    assert len(blocks) == -(-(n_frames - 1) // k)
    assert peak <= 2, peak
    snap = pipe.counters.snapshot()
    assert snap["frames_ingested"] == n_frames
    assert snap["windows_processed"] == n_frames - 1
    assert snap["cfar_hits"] == hits > 0


# ------------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def cli_profile():
    """Both profile tables get ``BLOCK`` with tiled CFAR segments above the
    parity floor on the range axis, under one name."""
    prof = dataclasses.replace(BLOCK, segment_points=(40, 80, 224),
                               cfar_segments=((0, 40), (40, 120), (120, 344)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jconfig.PROFILES, "HPS", prof)
        mp.setitem(tconfig.PROFILES, "HPS", as_config(prof, tconfig))
        yield "HPS"


def test_cli_stream_block_windows_matches_jax(tmp_path, capsys, cli_profile):
    cap = _capture(tmp_path / "cap", jconfig.PROFILES[cli_profile], 5, seed=11, target=90)
    args = ["stream", "--input", cap, "--profile", cli_profile, "--frames", "5",
            "--win-size", "2", "--clutter-v", "0.5", "--max-detections", "8",
            "--block-windows", "2", "--emit", "detections", "--no-native"]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seen = []
    assert tcli.main(args + ["--device", "cpu"], on_result=seen.append) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r.frame_idx for r in seen] == [f["frame"] for f in want["frames"]] == [0, 1, 2, 3]
    assert all(r.rdms is None and r.flags is None for r in seen)
    for g, w in zip(got["frames"], want["frames"]):
        assert (g["cfar_hits"], g["detections_per_beam"]) == (
            w["cfar_hits"], w["detections_per_beam"])
    for key in ("frames_ingested", "windows_processed", "cfar_hits"):
        assert got["counters"][key] == want["counters"][key], key


def test_cli_mtd_and_detect_cpu_routes_match_jax(tmp_path, monkeypatch, cli_profile):
    """``mtd --device cpu`` compresses each frame once (PC calls = frames)
    and writes the JAX CLI's RDMs; ``detect --device cpu`` (``make_flags``,
    then the extraction) writes its flags bit for bit on the same RDM
    files."""
    calls = []
    real = hp.segmented_pulse_compression
    monkeypatch.setattr(hp, "segmented_pulse_compression",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cap = _capture(tmp_path / "cap", jconfig.PROFILES[cli_profile], 4, seed=12, target=90)
    common = ["--profile", cli_profile]
    frames = str(tmp_path / "frames")
    assert jcli.main(["ingest", "--input", cap, "--output", frames, "--frames", "4"]
                     + common) == 0
    out = {}
    for pkg, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        out[pkg, "r"], out[pkg, "d"] = str(tmp_path / f"{pkg}_rdm"), str(tmp_path / f"{pkg}_det")
        assert main(["mtd", "--input", frames, "--output", out[pkg, "r"], "--frames", "3",
                     "--win-size", "2"] + common + extra) == 0
        assert main(["detect", "--input", out["jax", "r"], "--output", out[pkg, "d"],
                     "--frames", "3", "--threshold", "5", "--clutter-v", "0.5"]
                    + common + extra) == 0
    assert len(calls) == 4
    for f in range(3):
        got, want = tload_frame(out["port", "r"], f)[0], jload_frame(out["jax", "r"], f)[0]
        peak = np.abs(want["rdm"]).max()
        np.testing.assert_allclose(got["rdm"], want["rdm"], rtol=RTOL, atol=2e-5 * peak)
        got, want = tload_frame(out["port", "d"], f)[0], jload_frame(out["jax", "d"], f)[0]
        np.testing.assert_array_equal(got["flags"], want["flags"])
        np.testing.assert_array_equal(got["vflags"], want["vflags"])
        for idx in np.ndindex(*want["det_valid"].shape[:-1]):
            cells = [set(zip(a["det_v"][idx][a["det_valid"][idx]].tolist(),
                             a["det_r"][idx][a["det_valid"][idx]].tolist()))
                     for a in (got, want)]
            assert cells[0] == cells[1], idx

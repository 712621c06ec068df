"""The G1 stream: ``StreamingPipeline`` over a G1 radar's two beams, with the
profile's range re-concatenation after pulse compression, at a tiny
G1-shaped profile with a table of its own (``TABLE``: the G1 table's form,
narrow / mid / long, cut to 344 samples).

Held against the benchmark's plain reference (``benchmark/reference/g1.py``:
RDMs within the repo's f32 tolerance of the peak, flags and lists exact),
against the JAX package's functions composed (pulse compression,
``range_concatenate``, the windowed MTD, ``detect_rdm``), and ``cli stream``
over a capture from the port's ``write_g1_capture`` against the windowed
chain on the reader's frames.  A profile without a table takes the same
operators as before.
"""

import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import cfar as ref_cfar
from benchmark.reference import g1 as ref_g1
from benchmark.systems.g1_stream import g1_frames
from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.models import detect as jdetect
from radar_signal_process_tpu.models import mtd_pipeline as jmtd
from radar_signal_process_tpu.ops import pulse_compression as jpc
from radar_signal_process_tpu.ops.waveforms import reference_pulses
from radar_signal_process_tpu_torch import cli as tcli
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.ingest import g1_reader_class
from radar_signal_process_tpu_torch.models.detect import Detector, clutter_cells
from radar_signal_process_tpu_torch.models.mtd_pipeline import (
    FrameProcessor,
    _form_rdm,
    slice_cpi_window,
)
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline, TwoBeamReader
from radar_signal_process_tpu_torch.ops.pulse_compression import segmented_pulse_compression
from radar_signal_process_tpu_torch.params import chain_params
from radar_signal_process_tpu_torch.sim import write_g1_capture
from radar_signal_process_tpu_torch.utils import profiling
from tests.test_torch_import import as_config

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL, PEAK_ATOL = 2e-4, 2e-5
TABLE = ((0, 40, 0), (40, 113, 47), (113, 257, 200))
TG1 = dataclasses.replace(
    tconfig.G1_PROFILE, name="TG1", prt_per_frame=32, point_prt=344,
    segment_points=(40, 80, 224), cfar_segments=((0, 40), (40, 113), (113, 257)))
N_FRAMES = 4
MAX_DET = 16


def _config() -> dict:
    """``benchmark/configs/g1.json`` at TG1's geometry and table."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "g1.json"
    cfg = json.loads(path.read_text())
    cfg["profile"].update(prt_per_frame=TG1.prt_per_frame, point_prt=TG1.point_prt,
                          segment_points=list(TG1.segment_points),
                          cfar_segments=[list(s) for s in TG1.cfar_segments])
    cfg["range_concat"] = [list(e) for e in TABLE]
    cfg["scene"]["targets"].update(count=3, amplitude=[40.0, 80.0])
    return cfg


@pytest.fixture(scope="module", autouse=True)
def tables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfig.RANGE_CONCAT, "TG1", TABLE)
        mp.setitem(tconfig.PROFILES, "TG1", TG1)
        yield


@pytest.fixture(scope="module")
def frames():
    """(N_FRAMES, 2, 32, 344) integer-valued complex64 frames with targets."""
    return g1_frames(_config(), N_FRAMES, 100.0, 2 ** 31 + 11, CPU)[0]


class _Frames:
    """A G1-format reader over frames in memory: frames from 1, ``(left,
    right, angles, meta)``; past the last one a short read."""

    def __init__(self, frames):
        self.frames = frames

    def read_frame(self, idx):
        if idx > len(self.frames):
            raise EOFError("end of the capture")
        f = self.frames[idx - 1]
        return f[0], f[1], np.zeros(f.shape[1]), {}


def _stream(frames, block: bool):
    pipe = StreamingPipeline(TwoBeamReader(_Frames(frames)), TG1, win_size=4, clutter_v=3.0,
                             max_detections=MAX_DET, device="cpu", use_host_parallel=block,
                             block_windows=2)
    return list(pipe)


def _n_clutter():
    return clutter_cells(TG1, TG1.prt_per_frame, 3.0)


def _assert_rdm_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    np.testing.assert_allclose(got / peak, want / peak, rtol=RTOL, atol=PEAK_ATOL)


# ------------------------------------------------------------ the reference
@pytest.mark.parametrize("block", [False, True], ids=["windowed", "block"])
def test_stream_matches_the_reference(frames, block):
    """Every window: RDMs within f32 rounding of the float64 reference,
    flags those of the reference cascade on the stream's RDMs, detection
    lists the reference's stable-sort lists."""
    cfg = _config()
    assert ref_g1.n_clutter(cfg) == _n_clutter()
    results = _stream(frames, block)
    assert [r.frame_idx for r in results] == list(range(N_FRAMES - 1))
    for res in results:
        ref = ref_g1.window_rdms(frames[res.frame_idx], frames[res.frame_idx + 1], cfg, CPU)
        assert tuple(res.rdms.shape) == (2, 4, 32, TABLE[-1][1])
        assert float((res.rdms.double() - ref).abs().max() / ref.max()) < PEAK_ATOL
        flags, _ = ref_g1.cascade(res.rdms, cfg)
        assert torch.equal(flags, res.flags)
        assert res.cfar_hits == int(flags.sum()) > 0
        amp, cells = ref_g1.detection_list(res.flags, res.rdms, cfg)
        d = res.detections
        assert ref_cfar.detection_mismatches(d.amplitude.numpy(), d.v_idx.numpy(),
                                             d.r_idx.numpy(), amp, cells) == 0


def test_beams_pinned_as_one_block(frames):
    """A G1 frame's two beams land in one (beams, prt, samples) block; the
    consumer's permute gives it back contiguous, with no copy."""
    pipe = StreamingPipeline(TwoBeamReader(_Frames(frames)), TG1, device="cpu",
                             use_host_parallel=False)
    host = pipe._pin(TwoBeamReader(_Frames(frames)).read_frame(1))
    assert tuple(host.shape) == (32, 344, 2)
    staged = pipe._stage(host)
    assert staged.is_contiguous() and staged.data_ptr() == host.data_ptr()
    assert torch.equal(staged, torch.from_numpy(frames[1]))


def test_end_of_capture_and_concat_span(frames):
    """The stream ends at the reader's short read; each window records its
    ``mtd.concat`` launch span."""
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            results = _stream(frames[:3], block=False)
        names = [s.name for s in profiling.spans() if s.kind == "launch"]
    finally:
        profiling.clear()
    assert len(results) == 2
    assert names.count("mtd.concat") == 2
    assert names.index("mtd.pc") < names.index("mtd.concat") < names.index("mtd.slice")


# ---------------------------------------------------------- the JAX package
def test_window_matches_the_jax_functions_composed(frames):
    """One window through the JAX package's pulse compression,
    ``range_concatenate``, windowed MTD and ``detect_rdm``: RDMs within the
    f32 tolerance; each package's CFAR on the other's RDM gives the same
    flags."""
    jprof = as_config(TG1, jconfig)
    window = np.concatenate([frames[0], frames[1]], axis=1)
    pc = jpc.segmented_pulse_compression(jnp.asarray(window), jprof, reference_pulses(jprof))
    pc = jpc.range_concatenate(pc, TABLE)
    want = np.asarray(jmtd._form_rdm(jmtd.slice_cpi_window(pc, 4), jprof, use_pallas_rdm=False))
    got = _stream(frames[:2], block=False)[0]
    _assert_rdm_close(got.rdms.numpy(), want)
    nc = _n_clutter()
    assert nc == jdetect.clutter_cells(jprof, TG1.prt_per_frame)
    j_flags, _ = jdetect.detect_rdm(jnp.asarray(got.rdms.numpy()), jprof, nc, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(j_flags), got.flags.numpy())
    t_flags, _, _ = Detector(TG1, nc, MAX_DET)(torch.from_numpy(np.array(want, np.float32)))
    w_flags, _ = jdetect.detect_rdm(jnp.asarray(want), jprof, nc, use_pallas=False)
    np.testing.assert_array_equal(t_flags.numpy(), np.asarray(w_flags))
    assert int(t_flags.sum()) > 0


# ---------------------------------------------------------------- cli stream
@pytest.mark.parametrize("native", ["--native", "--no-native"])
def test_cli_stream_g1_capture(frames, tmp_path, capsys, native):
    """``cli stream --profile TG1`` over a written G1 capture (CPU: the
    block path) gives the windowed chain's RDMs, flags and lists on the
    reader's frames, and ends cleanly at the capture's end."""
    cap = str(tmp_path / "cap")
    write_g1_capture(cap, frames[:, 0], frames[:, 1])
    reader = g1_reader_class(native == "--native")(cap, prt_num=32, point_prt=344)
    read = np.stack([np.stack(reader.read_frame(i + 1)[:2]) for i in range(N_FRAMES)])
    np.testing.assert_array_equal(read, frames)
    want = _stream(read.astype(np.complex64), block=False)
    got = []
    args = tcli.build_parser().parse_args(
        ["stream", "--input", cap, "--profile", "TG1", "--frames", "10", "--device", "cpu",
         "--max-detections", str(MAX_DET), native])
    assert tcli.cmd_stream(args, on_result=got.append) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [f["frame"] for f in out["frames"]] == [0, 1, 2]
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        _assert_rdm_close(g.rdms.numpy(), w.rdms.numpy())
        assert torch.equal(g.flags, w.flags) and g.cfar_hits == w.cfar_hits > 0
        for a, b in zip(g.detections, w.detections):
            assert torch.equal(a, b)


# ------------------------------------------------------- profiles with none
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_profile_without_a_table_takes_the_same_ops():
    """G2 has no table: the windowed path runs exactly the operators of
    compression, slicing and B2, and records no ``mtd.concat`` span."""
    assert tconfig.range_concat(tconfig.G2_PROFILE) == ()
    prof = dataclasses.replace(tconfig.G2_PROFILE, prt_per_frame=16, point_prt=344,
                               segment_points=(40, 80, 224), n_beams=2, n_channels=2)
    params = chain_params(prof, device=CPU)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy((rng.standard_normal((2, 16, 344))
                              + 1j * rng.standard_normal((2, 16, 344))).astype(np.complex64))
            for _ in range(2))
    proc = FrameProcessor(prof, params, 4, tconfig.range_concat(prof))
    with _Ops() as seen:
        got = proc(a, b)
    with _Ops() as plain:
        pc = segmented_pulse_compression(torch.cat([a, b], dim=-2), prof, params.pc_spectra,
                                         params.pc_filter_lens)
        want = _form_rdm(slice_cpi_window(pc, 4), prof, params)
    assert seen.ops == plain.ops
    assert torch.equal(got, want)


def test_table_checked_against_the_profile():
    """The full G1 table on a profile 344 samples wide, or a table with a
    gap, is refused."""
    assert tconfig.range_concat(tconfig.G1_PROFILE) == tconfig.G1_RANGE_CONCAT
    assert tconfig.range_concat(TG1) == TABLE
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfig.RANGE_CONCAT, "TG1", tconfig.G1_RANGE_CONCAT)
        with pytest.raises(ValueError, match="does not fit"):
            tconfig.range_concat(TG1)
        mp.setitem(tconfig.RANGE_CONCAT, "TG1", ((0, 40, 0), (41, 100, 50)))
        with pytest.raises(ValueError, match="does not fit"):
            tconfig.range_concat(TG1)

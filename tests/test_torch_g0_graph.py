"""The G0 chain's graph path, on the CPU.

On a CUDA device ``G0Chain.process_frame`` replays everything after the
beams' copy as one CUDA graph per ``n_clutter``, reading the frame's values
from a block of the card's memory.  What can be held on the CPU is held
here: the constants made once (spline matrices, notch masks, the table of
frame values) against the functions that made them per call; the graph key
of the benchmark's frequency plan; the flat output block; and the path's
control flow, replayed by a stand-in graph that records the operations of
the capture and runs them again on the same tensors.  The card's own tests
are in ``test_torch_gpu.py``.
"""

import contextlib
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference import g0 as ref_g0
from benchmark.systems.g2_stream import port_profile
from radar_signal_process_tpu_torch.config import G0_PROFILE, G0ChainConfig
from radar_signal_process_tpu_torch.models import g0_chain
from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
from radar_signal_process_tpu_torch.ops import measure as tmeasure
from radar_signal_process_tpu_torch.ops import mtd as tmtd
from radar_signal_process_tpu_torch.ops.tables import angle_k_values

torch.set_num_threads(2)

G0_TINY = dataclasses.replace(G0_PROFILE, prt_per_frame=128, point_prt=182,
                              segment_points=(62, 120))
# a clutter velocity at which the 11 frequencies give two clutter-row counts
TINY_CHAIN = G0ChainConfig(mtd_fft_length=256, pc_fft_length=128, mtd_clutter_v=3.59)
G0_CONFIG = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "g0.json"


def _frame(seed):
    rng = np.random.default_rng(seed)
    shape = (2, G0_TINY.prt_per_frame, G0_TINY.point_prt)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    pulses = np.arange(shape[1])
    x[:, :, 20] += 50.0 * np.exp(1j * 2 * np.pi * 0.1 * (1 + seed % 3) * pulses)
    x[:, :, 90] += 80.0 * np.exp(-1j * 2 * np.pi * 0.2 * pulses)
    return x.astype(np.complex64)


def _tensors(result):
    return [t for t in g0_chain._leaves(result) if t is not None]


def _assert_same(got, want):
    g, w = g0_chain._leaves(got), g0_chain._leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------- constants made once
def test_g0_chain_makes_its_constants_once(monkeypatch):
    chain = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")
    w = 2 * TINY_CHAIN.extra_dots + 1
    for got, u in zip(chain.splines, (TINY_CHAIN.r_interp_times, TINY_CHAIN.v_interp_times)):
        assert got.dtype == torch.float32 and got.device == chain.device
        assert torch.equal(got, torch.from_numpy(tmeasure.spline_eval_matrix(w, u)).float())
    n_fft = TINY_CHAIN.mtd_fft_length
    keys = {chain.frame_params(f, 0)[1] for f in range(11)}
    assert sorted(chain.notch_keep) == sorted(keys) and len(keys) == 2
    for n_c, keep in chain.notch_keep.items():
        assert torch.equal(keep, torch.from_numpy(tmtd.notch_mask_unshifted(n_fft, n_c)))
    # each row of the frame table holds the frame's float64 values as float32
    k_table = angle_k_values(TINY_CHAIN.sys_num)
    for fi, bp in ((0, 0), (5, 2), (10, 11)):
        params, _ = chain.frame_params(fi, bp)
        row = chain.frame_values[fi * k_table.shape[1] + bp]
        assert torch.equal(row[:n_fft], params.v_scale)
        want = np.array([params.delta_v, k_table[fi, bp],
                         bp * TINY_CHAIN.beam_angle_step + 2.5]).astype(np.float32)
        assert torch.equal(row[n_fft:], torch.from_numpy(want))

    # a frame makes none of them again on the host
    def refuse(*args, **kwargs):
        raise AssertionError("a constant made on the host during a frame")

    monkeypatch.setattr(tmeasure, "spline_eval_matrix", refuse)
    monkeypatch.setattr(tmtd, "notch_mask_unshifted", refuse)
    made = (chain.splines, dict(chain.notch_keep), chain.frame_values)
    x = _frame(1)
    for fi in (0, 10):
        chain.process_frame(x[0], x[1], freq_index=fi, beam_pos=3)
    assert chain.splines is made[0] and chain.notch_keep == made[1]
    assert chain.frame_values is made[2]


def test_g0_graph_key_of_the_benchmark_plan():
    """The benchmark's G0 configuration: 11 frequencies and one n_clutter,
    so one graph serves every frame; computed, as the reference does."""
    cfg = json.loads(G0_CONFIG.read_text())
    chain = G0Chain(port_profile(cfg), G0ChainConfig(**cfg["chain"]), device="cpu")
    n_freq, n_beam = angle_k_values(chain.chain.sys_num).shape
    keys = {chain.frame_params(f, b)[1] for f in range(n_freq) for b in range(n_beam)}
    assert n_freq == len(cfg["freq_table_mhz"]) == 11
    assert len(keys) == 1
    assert keys == {ref_g0.frame_scalars(cfg, f, 0)["n_clutter"] for f in range(n_freq)}
    assert set(chain.notch_keep) == keys


def test_g0_cpu_chain_counts_only_eager_frames():
    chain = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")
    x = _frame(2)
    for fi in (3, 3, 10):
        chain.process_frame(x[0], x[1], freq_index=fi, beam_pos=1)
    assert (chain.eager_frames, chain.replays, chain.captures) == (3, 0, 0)


@pytest.mark.parametrize("width_db", [None, -10.0], ids=["plain", "spectral-width"])
def test_g0_result_packs_into_one_block_and_back(width_db):
    chain = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, spectral_width_db=width_db, device="cpu")
    x = _frame(3)
    res = chain.process_frame(x[0], x[1])
    block, layout, skeleton = g0_chain.pack_result(res)
    assert block.dtype == torch.uint8 and block.dim() == 1
    assert block.numel() == sum(t.numel() * t.element_size() for t in _tensors(res))
    assert (res.measurements_long.spectral_width is None) == (width_db is None)
    _assert_same(g0_chain.unpack_result(block.clone(), layout, skeleton), res)


def test_g0_chain_refuses_a_beam_of_another_shape():
    chain = G0Chain(G0_TINY, TINY_CHAIN, device="cpu")
    x = _frame(4)
    with pytest.raises(ValueError, match="a beam of"):
        chain.process_frame(x[0][:, :-1], x[1][:, :-1])


# ------------------------------------------------------- the beams' copy
def test_g0_cpu_beams_make_no_ring():
    chain = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")
    x = _frame(5)
    for fi in (3, 10):
        chain.process_frame(x[0], x[1], freq_index=fi, beam_pos=1)
    assert torch.equal(chain.beams(x[0], x[1]), torch.from_numpy(x))
    assert chain._ring is None and (chain.pinned_frames, chain.slot_waits) == (0, 0)


def test_g0_cpu_chain_accepts_a_complex128_beam():
    chain = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")
    x = _frame(6)
    wide = x.astype(np.complex128)
    assert torch.equal(chain.beams(wide[0], wide[1]), torch.from_numpy(x))
    _assert_same(chain.process_frame(wide[0], wide[1]), chain.process_frame(x[0], x[1]))


class _Event:
    """A stand-in for ``torch.cuda.Event``: ``busy`` queries report the copies
    out of the slot still running; each record is counted."""

    def __init__(self):
        self.busy, self.records, self.waits = 0, 0, 0

    def query(self):
        self.busy -= 1
        return self.busy < 0

    def synchronize(self):
        self.waits += 1

    def record(self, stream=None):
        self.records += 1


def _staging(monkeypatch, rows_a_block):
    """A CPU chain whose ring is two plain host slots with stand-in events,
    in blocks of ``rows_a_block`` rows."""
    monkeypatch.setattr(g0_chain, "STAGE_BLOCK_BYTES", rows_a_block * G0_TINY.point_prt * 8)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    monkeypatch.setattr(G0Chain, "_pinned_ring", lambda self, shape: [
        (torch.empty(shape, dtype=torch.complex64), _Event()) for _ in range(2)])
    return G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")


BEAM_FORMS = {
    "complex64": np.copy,
    "complex128": lambda x: x.astype(np.complex128),
    "cpu-tensor": lambda x: torch.from_numpy(x.copy()),
    "reversed-rows": lambda x: np.ascontiguousarray(x[::-1])[::-1],
    "big-endian": lambda x: x.astype(">c8"),
}


@pytest.mark.parametrize("form", list(BEAM_FORMS))
def test_g0_pinned_slots_stage_the_beams_in_row_blocks(monkeypatch, form):
    """Through the ring (on the CPU, with plain slots): each beam arrives
    whole and as complex64 from every host form, in three blocks of rows
    for a block size of 50 rows (43, 43 and 42) whose ``g0.pin`` and ``g0.h2d`` spans each count the
    frame's bytes once; the slots alternate, each records its event once a
    frame, and the caller's arrays are free when the copy returns."""
    from radar_signal_process_tpu_torch.utils import profiling

    chain = _staging(monkeypatch, 50)
    frames = [_frame(k) for k in range(3)]
    profiling.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for x in frames:
                beams = [BEAM_FORMS[form](b) for b in x]
                out = chain._stage(beams, torch.empty(x.shape, dtype=torch.complex64))
                for b in beams:
                    b[...] = 0
                assert out.dtype == torch.complex64 and torch.equal(out, torch.from_numpy(x))
        got = profiling.spans()
    finally:
        profiling.clear()
    blocks = [43, 43, 42] * 2
    row = G0_TINY.point_prt * 8
    for name, kind in (("g0.pin", "pin"), ("g0.h2d", "copy")):
        sizes = [s.nbytes for s in got if s.name == name]
        assert {s.kind for s in got if s.name == name} == {kind}
        assert sizes == [n * row for n in blocks] * len(frames)
        assert sum(sizes) == len(frames) * frames[0].nbytes
    assert [s.name for s in got[:2]] == ["g0.pin", "g0.h2d"]
    assert [e.records for _, e in chain._ring] == [2, 1]
    assert (chain.pinned_frames, chain.slot_waits) == (3, 0)


def test_g0_pinned_slot_waits_for_the_card_before_its_reuse(monkeypatch):
    """A slot whose copies out have not run when the host comes back to it
    is waited on, and counted; the one-block beam (the chain's own size)
    takes one block a beam."""
    chain = _staging(monkeypatch, 4 * G0_TINY.prt_per_frame)
    x = _frame(7)
    for k in range(4):
        if k == 2:
            chain._ring[0][1].busy = 1      # frame 0's copies still running
        out = chain._stage(tuple(x), torch.empty(x.shape, dtype=torch.complex64))
        assert torch.equal(out, torch.from_numpy(x))
    assert (chain.pinned_frames, chain.slot_waits) == (4, 1)
    assert [e.waits for _, e in chain._ring] == [1, 0]


# ------------------------------------------- the graph path, on a stand-in
class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((func, args, kwargs or {}, out))
        return out


class _RecordedGraph:
    """A stand-in for ``torch.cuda.CUDAGraph``: the capture runs and records
    every operation; a replay runs them again and writes each result into
    the tensor the capture made, as a graph's kernels write the same memory."""

    def __init__(self):
        self.ops = []

    def replay(self):
        for func, args, kwargs, out in self.ops:
            new = func(*args, **kwargs)
            pairs = zip(out, new) if isinstance(out, (tuple, list)) else ((out, new),)
            for old, fresh in pairs:
                if isinstance(old, torch.Tensor) and old.data_ptr() != fresh.data_ptr():
                    old.copy_(fresh)

    def pool(self):
        return "pool"


@contextlib.contextmanager
def _recording(graph, pool=None, stream=None, capture_error_mode=None):
    recorder = _Recorder()
    with recorder:
        yield
    graph.ops = recorder.ops


class _Stream:
    def wait_stream(self, other):
        pass


def _graphed(chain):
    """``chain`` (on the CPU) set on the graph path, as a CUDA device sets it."""
    chain._graphed = True
    chain._input = torch.empty((2, G0_TINY.prt_per_frame, G0_TINY.point_prt),
                               dtype=torch.complex64)
    chain._frame_block = torch.empty(TINY_CHAIN.mtd_fft_length + 3)
    return chain


def test_g0_graph_path_replays_each_frames_values(monkeypatch):
    """Frames of every frequency and two beams, over two graph keys: each
    replay equals the eager chain bit for bit (so it reads its frame's
    beams, velocity scale, slope and elevation from the static buffers),
    no later frame changes a result held, and the counters add up."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _RecordedGraph)
    monkeypatch.setattr(torch.cuda, "graph", _recording)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    eager = G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu")
    chain = _graphed(G0Chain(G0_TINY, TINY_CHAIN, 5, 2, device="cpu"))
    plan = [(f, b) for f in (0, 10, 3, 7, 5, 1) for b in (0, 7)]
    keys = {chain.frame_params(f, b)[1] for f, b in plan}
    assert len(keys) == 2
    held = []
    for k, (fi, bp) in enumerate(plan):
        x = _frame(k)
        got = chain.process_frame(x[0], x[1], freq_index=fi, beam_pos=bp)
        _assert_same(got, eager.process_frame(x[0], x[1], freq_index=fi, beam_pos=bp))
        held.append((got, [t.clone() for t in _tensors(got)]))
    for got, copy in held:
        assert all(torch.equal(a, b) for a, b in zip(_tensors(got), copy))
    assert chain.captures == chain.eager_frames == len(keys)
    assert chain.replays == len(plan) - len(keys)

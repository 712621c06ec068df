"""The port's host-clock spans (``utils/profiling.py``) and the four
benchmark readers that read them.

A span records only inside a ``torch.profiler`` session, touches nothing on
the card, and leaves the chain's outputs bit for bit as they are; the
readers are held to values worked out by hand on a synthetic trace.
"""

import dataclasses
import inspect
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import Spans, Trace
from benchmark.metrics import (g0_pin_copy_ms, h2d_gbps, host_launch_ms, idle_launch_pct,
                               stage_pin_copy_ms)
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, G0ChainConfig
from radar_signal_process_tpu_torch.ingest import FrameResult
from radar_signal_process_tpu_torch.models.g0_chain import G0Chain
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
from radar_signal_process_tpu_torch.utils import StageTimers, profiling
from radar_signal_process_tpu_torch.utils.profiling import span

# a windowed G2 stream and a G0 chain small enough for the CPU
G2_TINY = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=128, segment_points=(24, 40, 64),
    cfar_segments=((0, 24), (24, 64), (64, 128)), n_channels=3, n_beams=2,
)
G0_TINY = dataclasses.replace(G0_PROFILE, prt_per_frame=128, point_prt=182,
                              segment_points=(62, 120))
G0_TINY_CHAIN = G0ChainConfig(mtd_fft_length=256, pc_fft_length=128)

G2_SPANS = {"stream.pin": "pin", "stream.h2d": "copy", "stream.dbf": "launch",
            "mtd.pc": "launch", "mtd.slice": "launch", "mtd.rdm": "launch",
            "detect.cfar": "launch", "detect.extract": "launch"}
G0_SPANS = {"g0.h2d": "copy", "g0.params": "launch", "g0.front": "launch",
            "g0.combine": "launch", "g0.cfar": "launch", "g0.extract": "launch",
            "g0.measure": "launch"}


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


def recording():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


# ------------------------------------------------------------------- the store
def test_nothing_recorded_without_a_profiler():
    with span("a", "launch"), span("b", "copy", 8) as s:
        s.nbytes = 16
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert span("a", "launch") is span("c", "pin")      # one shared object, no allocation


def test_spans_recorded_under_a_cpu_profiler():
    before = time.perf_counter()
    with recording():
        with span("copy.step", "copy", 1024):
            pass

        def other():
            with span("pin.step", "pin") as s:
                s.nbytes = 64

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with span("launch.step", "launch"):
            pass
    after = time.perf_counter()
    with span("after", "launch"):
        pass
    got = profiling.spans()
    assert [(s.name, s.kind, s.nbytes) for s in got] == [
        ("copy.step", "copy", 1024), ("pin.step", "pin", 64), ("launch.step", "launch", 0)]
    assert [s.thread for s in got] == [threading.get_ident(), t.ident, threading.get_ident()]
    assert all(before <= s.t0 <= s.t1 <= after for s in got)
    with recording(), pytest.raises(ValueError, match="kind"):
        span("x", "sync")


def test_cap_and_drop_count(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with recording():
        for i in range(5):
            with span(f"s{i}", "launch"):
                pass
    assert [s.name for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_store_loses_no_record_across_threads(monkeypatch):
    """More threads than cores, switching often, past the cap: every span is
    either kept or counted as dropped, and no more than the cap are kept."""
    monkeypatch.setattr(profiling, "CAPACITY", 5000)
    n_threads, per = max(16, 2 * (os.cpu_count() or 1)), 500

    def work():
        for _ in range(per):
            with span("s", "launch"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    kept = len(profiling.spans())
    assert kept == min(5000, n_threads * per)
    assert kept + profiling.dropped() == n_threads * per


def test_stage_timers_open_a_launch_span():
    timers = StageTimers("cpu")
    with recording():
        with timers.stage("mtd"):
            pass
    assert [(s.name, s.kind) for s in profiling.spans()] == [("mtd", "launch")]
    assert timers.summary()["mtd"]["count"] == 1


# ------------------------------------------------------------ the chains
class _Frames:
    """A reader over frames in memory: ``order[i]`` is frame i's source."""

    def __init__(self, frames, order):
        self.frames, self.order = frames, order

    def read_frame(self, idx):
        if idx >= len(self.order):
            return FrameResult(None, None, False, True, {})
        iq = self.frames[self.order[idx]]
        return FrameResult(iq, np.zeros(iq.shape[0]), True, False, {})


def _g2_frames(seed=3):
    rng = np.random.default_rng(seed)
    p = G2_TINY
    shape = (2, p.prt_per_frame, p.point_prt, p.n_channels)
    iq = (rng.integers(-300, 300, shape) + 1j * rng.integers(-300, 300, shape))
    iq[:, :, 40, :] += 20000.0 * np.exp(1j * 2 * np.pi * 0.2 * np.arange(p.prt_per_frame))[:, None]
    coeffs = rng.standard_normal((p.n_beams, p.n_channels)) \
        + 1j * rng.standard_normal((p.n_beams, p.n_channels))
    return iq.astype(np.complex64), coeffs


def _g2_run():
    """The windowed stream over frames A, B, A, B, A: windows 0 and 2 are
    (A, B), 1 and 3 are (B, A)."""
    frames, coeffs = _g2_frames()
    pipe = StreamingPipeline(_Frames(frames, [0, 1, 0, 1, 0]), G2_TINY, win_size=2,
                             clutter_v=1e-6, max_detections=8, dbf_coeffs=coeffs,
                             device="cpu", use_host_parallel=False)
    return list(pipe)


def _g0_frame(seed=5):
    rng = np.random.default_rng(seed)
    shape = (2, G0_TINY.prt_per_frame, G0_TINY.point_prt)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    x[:, :, 20] += 50.0 * np.exp(1j * 2 * np.pi * 0.1 * np.arange(shape[1]))
    return x.astype(np.complex64)


def _g0_run(n=2):
    chain = G0Chain(G0_TINY, G0_TINY_CHAIN, freq_index=5, beam_pos=2, device="cpu")
    left, right = _g0_frame()
    return [chain.process_frame(left, right, freq_index=3, beam_pos=1) for _ in range(n)]


def _no_card(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span touched the card")

    for name in ("synchronize", "Event", "current_stream", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)


def test_span_code_names_nothing_on_the_card():
    for obj in (profiling.span, profiling._On, profiling._Off, profiling.spans,
                profiling.clear, profiling.dropped):
        src = inspect.getsource(obj)
        assert "torch" not in src, obj


def test_span_path_calls_nothing_on_the_card(monkeypatch):
    with recording():
        _no_card(monkeypatch)
        g2 = _g2_run()
        g0 = _g0_run(1)
        monkeypatch.undo()
    assert len(g2) == 4 and len(g0) == 1
    got = profiling.spans()
    kinds = {s.name: s.kind for s in got}
    assert {k: kinds.get(k) for k in G2_SPANS} == G2_SPANS
    assert {k: kinds.get(k) for k in G0_SPANS} == G0_SPANS
    p = G2_TINY
    frame = p.prt_per_frame * p.point_prt * p.n_channels * 8
    for name in ("stream.pin", "stream.h2d"):
        assert [s.nbytes for s in got if s.name == name] == [frame] * 5, name
    beam = G0_TINY.prt_per_frame * G0_TINY.point_prt * 8
    assert [s.nbytes for s in got if s.name == "g0.h2d"] == [beam, beam]
    assert all(s.nbytes == 0 for s in got if s.kind == "launch")
    producer = {s.thread for s in got if s.name == "stream.pin"}
    assert producer and threading.get_ident() not in producer


def _g2_outputs(results):
    return [(r.frame_idx, r.rdms, r.flags, r.cfar_hits, tuple(r.detections)) for r in results]


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_outputs_bit_for_bit_with_recording_on_and_off():
    off = _g2_outputs(_g2_run())
    with recording():
        on = _g2_outputs(_g2_run())
    assert profiling.spans()
    _assert_same(on, off)
    assert [w[0] for w in off] == [0, 1, 2, 3] and off[0][3] > 0
    # the same window on two occurrences: the same bits, the same list
    for a, b in ((0, 2), (1, 3)):
        _assert_same(off[a][1:], off[b][1:])
    g0_off = _g0_run(2)
    with recording():
        g0_on = _g0_run(1)
    for res in (g0_off[1], g0_on[0]):
        _assert_same(tuple(res), tuple(g0_off[0]))
    assert bool(g0_off[0].measurements_short.valid.any())


# ------------------------------------------------------------ the readers
def _ctx(kernels, steps=4):
    trace = Trace(False, torch.device("cpu"))
    trace.t0, trace.t1, trace.steps = 100.0, 101.0, steps
    trace.kernels = kernels
    return SimpleNamespace(trace=trace)


KERNELS = [("Memcpy HtoD", 0.0, 0.1), ("k1", 0.1, 0.3), ("Memcpy HtoD", 0.5, 0.6),
           ("k2", 0.55, 0.7)]       # busy [0, 0.3] and [0.5, 0.7]; gaps centred at 0.4, 0.85
SPANS = [
    ("stream.pin", "pin", 100.05, 100.065, 1, 1000),
    ("stream.pin", "pin", 100.5, 100.511, 1, 1000),
    ("stream.pin", "pin", 100.7, 100.713, 1, 1000),
    ("stream.pin", "pin", 99.9, 99.95, 1, 1000),            # before the traced part
    ("stream.h2d", "copy", 100.0, 100.001, 2, 200_000_000),
    ("g0.h2d", "copy", 100.49, 100.5, 2, 100_000_000),
    ("stream.h2d", "copy", 101.5, 101.6, 2, 999),           # after it
    ("mtd.pc", "launch", 100.35, 100.45, 2, 0),             # holds the first gap's middle
    ("detect.cfar", "launch", 100.8, 100.84, 2, 0),
    ("detect.extract", "launch", 100.86, 100.9, 2, 0),      # the second gap's middle falls between
    ("mtd.rdm", "launch", 101.2, 101.3, 2, 0),              # after it
]


def test_readers_by_hand(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: [profiling.Span(*s) for s in SPANS])
    ctx = _ctx(KERNELS)
    assert stage_pin_copy_ms.read(ctx) == pytest.approx(13.0)
    assert h2d_gbps.read(ctx) == pytest.approx(3e8 / 0.2 / 1e9)
    assert host_launch_ms.read(ctx) == pytest.approx((0.1 + 0.04 + 0.04) / 4 * 1e3)
    assert idle_launch_pct.read(ctx) == pytest.approx(100.0 * 0.2 / 1.0)
    # the union of overlapping launch spans, from two threads
    more = SPANS + [("stream.dbf", "launch", 100.83, 100.87, 1, 0)]
    monkeypatch.setattr(profiling, "spans", lambda: [profiling.Span(*s) for s in more])
    assert idle_launch_pct.read(ctx) == pytest.approx(100.0 * (0.2 + 0.3) / 1.0)


def test_g0_pin_copy_by_hand(monkeypatch):
    """Each whole frame of the traced part (a harness ``next`` span inside
    it) sums its ``g0.pin`` spans; the median of the sums, frames with none
    left out."""
    pins = [("g0.pin", "pin", 100.101, 100.102, 1, 10), ("g0.pin", "pin", 100.103, 100.105, 1, 10),
            ("g0.h2d", "copy", 100.102, 100.103, 1, 10),
            ("g0.pin", "pin", 100.201, 100.205, 1, 10), ("g0.pin", "pin", 100.206, 100.2065, 1, 10),
            ("g0.pin", "pin", 100.301, 100.302, 1, 10),
            ("g0.pin", "pin", 100.91, 100.92, 1, 10),      # its frame ends after the traced part
            ("g0.pin", "pin", 99.99, 99.995, 1, 10)]       # before it
    monkeypatch.setattr(profiling, "spans", lambda: [profiling.Span(*s) for s in pins])
    ctx = _ctx(KERNELS)
    ctx.spans = Spans()
    ctx.spans.items = [("next", 100.1, 100.15, 1), ("pull", 100.15, 100.16, 1),
                       ("next", 100.2, 100.25, 1), ("next", 100.3, 100.35, 1),
                       ("next", 100.4, 100.45, 1),        # no pinned copy
                       ("next", 100.9, 101.05, 1), ("next", 99.98, 99.999, 1)]
    assert g0_pin_copy_ms.read(ctx) == pytest.approx(3.0)
    ctx.spans.items = ctx.spans.items[2:]
    assert g0_pin_copy_ms.read(ctx) == pytest.approx(2.75)


@pytest.mark.parametrize("reader", [stage_pin_copy_ms, h2d_gbps, host_launch_ms, idle_launch_pct,
                                    g0_pin_copy_ms])
def test_readers_find_nothing_without_spans(monkeypatch, reader):
    ctx = _ctx(KERNELS)
    assert reader.read(ctx) is None                 # an empty store
    monkeypatch.delattr(profiling, "spans")         # a program with no spans at all
    assert reader.read(ctx) is None
    untraced = SimpleNamespace(trace=Trace(False, torch.device("cpu")))
    assert reader.read(untraced) is None

"""Entry points of the port: the flagship forward step and the multi-device
dry run.

Counterpart of the JAX system's ``__graft_entry__.py``:

* :func:`entry` returns the G2 forward step (13 beams x 4 CPI slices of
  segmented pulse compression, B2, the re-notch and B1) with its example
  window at full G2 width;
* :func:`dryrun_multichip` runs one step of every sharded path of
  ``parallel`` on an ``n``-rank mesh, each checked against the port's
  unsharded chain, and prints one line in the JAX line's form.

Run the dry run at the world size of the process group (one card per rank
on ``cuda``; gloo ranks on the CPU)::

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m radar_signal_process_tpu_torch.entry --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import os
import sys
import types
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from radar_signal_process_tpu_torch.config import (
    G0_PROFILE,
    G2_PROFILE,
    CFARConfig,
    MTDConfig,
    RadarProfile,
)
from radar_signal_process_tpu_torch.device import resolve_device
from radar_signal_process_tpu_torch.kernels import _build
from radar_signal_process_tpu_torch.kernels import cfar as kcfar
from radar_signal_process_tpu_torch.kernels import rdm as krdm
from radar_signal_process_tpu_torch.models.detect import detect_rdm
from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce, slice_cpi_window
from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline
from radar_signal_process_tpu_torch.ops.cfar import segmented_cfar
from radar_signal_process_tpu_torch.parallel.mesh import best_mesh_shape, make_mesh
from radar_signal_process_tpu_torch.parallel.multihost import initialize_distributed
from radar_signal_process_tpu_torch.parallel.sharding import (
    gather_blocks,
    local_block,
    make_expert_parallel,
    make_pipeline_parallel,
    make_sharded_e2e,
    make_sharded_pipeline,
    make_sharded_stream,
)

N_CLUTTER = 14                  # the forward step's clutter cells
WIN_SIZE = 4                    # CPI slices a window
# the dry run's stage-ring and routing profiles (JAX __graft_entry__.py)
PP_PROFILE = dataclasses.replace(
    G2_PROFILE, prt_per_frame=16, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)))
G0_PP_PROFILE = dataclasses.replace(
    G0_PROFILE, prt_per_frame=48, point_prt=160, segment_points=(32, 128),
    mtd=MTDConfig(window="hamming", notch_divisor=0, fft_length=64, fftshift=False))


class G2Step(nn.Module):
    """One G2 window ``(n_beams, 2*prt, point_prt)`` complex64 -> ``(rdms,
    cascade flags as float32)``, both ``(n_beams, 4, prt, point_prt)``:
    ``slice_cpi_window`` -> ``mtd_produce`` (PC, B2) -> ``detect_rdm``
    (re-notch, B1)."""

    def __init__(self, profile: RadarProfile, cfg: CFARConfig, n_clutter: int):
        super().__init__()
        self.profile = profile
        self.cfg = cfg
        self.n_clutter = n_clutter

    def forward(self, echo_window: torch.Tensor):
        rdms = mtd_produce(slice_cpi_window(echo_window, WIN_SIZE), self.profile)
        flags, _ = detect_rdm(rdms, self.profile, self.n_clutter, cfg=self.cfg)
        return rdms, flags.float()


def _gaussian(rng: np.random.Generator, shape) -> np.ndarray:
    """``rng.standard_normal(shape) + 1j * rng.standard_normal(shape)`` as
    complex64: the real draw first, each part rounded on its own."""
    out = np.empty(shape, dtype=np.complex64)
    out.real = rng.standard_normal(shape)
    out.imag = rng.standard_normal(shape)
    return out


def entry(device: str | torch.device = "cuda"):
    """``(forward, example)``: :class:`G2Step` at ``G2_PROFILE`` (n_clutter
    14, threshold 5) and a 1-tuple holding the 13 x 664 x 3404 complex64
    window from ``default_rng(0)`` on ``device`` (the card unless the
    caller asks for the CPU; a CUDA device that is absent raises)."""
    dev = resolve_device(device)
    prof = G2_PROFILE
    forward = G2Step(prof, CFARConfig(threshold=5.0), N_CLUTTER)
    shape = (prof.n_beams, 2 * prof.prt_per_frame, prof.point_prt)
    example = (torch.from_numpy(_gaussian(np.random.default_rng(0), shape)).to(dev),)
    return forward, example


class _ArrayReader:
    """``read_frame`` over in-memory ``(prt, samples, beams)`` cubes."""

    def __init__(self, cubes):
        self.cubes = cubes

    def read_frame(self, idx):
        done = idx < len(self.cubes)
        return types.SimpleNamespace(frame_completed=done,
                                     iq=self.cubes[idx] if done else None)


def _launches() -> dict:
    return {"doppler_rdm": krdm.doppler_rdm.launches,
            "cascaded_cfar2d": kcfar.cascaded_cfar2d.launches}


class _Run:
    """The dry run's bookkeeping on one rank: its device, whether it is
    rank 0 (which prints, checks and returns the legs' outputs), the
    checks that failed, raised once every collective is done, and the
    kernel launches the checks made."""

    def __init__(self, dev: torch.device, root: bool):
        self.dev = dev
        self.root = root
        self.failed: list = []
        self.out: dict = {}
        self.check_launches = dict.fromkeys(_launches(), 0)

    def put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.dev)

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failed.append(what)

    @contextlib.contextmanager
    def checking(self):
        """Kernel launches inside are the checks' own, not the legs'."""
        before = _launches()
        yield
        for k, v in _launches().items():
            self.check_launches[k] += v - before[k]

    @contextlib.contextmanager
    def leg(self, name: str):
        """On the card, rank 0 prints the device ms of the leg's sharded
        step (CUDA events; the first call, so the cuFFT plans and the NCCL
        communicators of its groups are set up inside it)."""
        if self.dev.type != "cuda":
            yield
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        if self.root:
            print(f"dryrun_multichip: {name} {start.elapsed_time(end):.3f} ms "
                  "(CUDA events, first call)")


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> Optional[dict]:
    """One step of every sharded path on an ``n_devices``-rank mesh, each
    checked against the port's unsharded chain (JAX ``__graft_entry__.py``:
    its legs, shapes, conditions and ``default_rng(0)`` draws, in its
    order).

    Runs in the process group that ``initialize_distributed(device)`` joins
    or forms (torchrun, or a group of one, left again on return);
    ``n_devices`` must be its world size.  On ``cuda`` each rank takes the
    card of its ``LOCAL_RANK``: no fallback to gloo or the CPU.  Rank 0,
    the first rank of every mesh here, prints one line per leg's device ms
    (on the card) and whether the stream's carried and recompressed RDMs
    are bit-identical, then the JAX line's form with the port's counts, and
    returns each leg's RDM and flags as a dict of tensors; the other ranks
    return ``None``.  A failed check raises on rank 0 once the collectives
    are done.  ``dryrun_multichip.check_launches`` holds the kernel launches
    this rank made for the checks (the unsharded chain, the recompressed
    stream window) in the last run, apart from the legs' own.
    """
    dev = resolve_device(device)
    formed = not dist.is_initialized()
    rank, world = initialize_distributed(dev.type)
    try:
        if n_devices != world:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process group of {world}")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
            _build.library()            # the kernels' build stays out of the legs' times
        run = _Run(dev, rank == 0)
        with torch.inference_mode():
            msg = _legs(run, n_devices)
        dryrun_multichip.check_launches = run.check_launches
        if not run.root:
            return None
        if run.failed:
            raise RuntimeError("dryrun_multichip: " + "; ".join(run.failed))
        print(msg)
        return run.out
    finally:
        if formed:
            dist.destroy_process_group()


def _legs(run: _Run, n_devices: int) -> str:
    prof = G2_PROFILE
    dp, sp = best_mesh_shape(n_devices, 2)
    mesh = make_mesh(("dp", "sp"), (dp, sp), run.dev.type)

    # tiny shapes: beams divisible by dp, pulses and range divisible by sp
    n_beams, n_prt, n_pts = dp * 2, sp * 8, prof.point_prt
    if n_pts % sp:
        n_pts = sp * (n_pts // sp)
    rng = np.random.default_rng(0)
    echo = _gaussian(rng, (n_beams, n_prt, n_pts))
    if n_pts != prof.point_prt:
        # the cut range extent; the stale CFAR segment table is dropped so
        # the sharded and unsharded detectors run the same whole-width split
        seg = list(prof.segment_points)
        seg[-1] -= prof.point_prt - n_pts
        prof = dataclasses.replace(prof, point_prt=n_pts, segment_points=tuple(seg),
                                   cfar_segments=())

    # the divisor-20 re-notch puts all-zero rows through the sharded
    # cascade, whose wrapped halo must not mark the real edge columns
    cfg = CFARConfig(threshold=5.0)
    step = make_sharded_pipeline(prof, mesh, cfg, n_clutter=2, renotch_divisor=20)
    x = local_block(run.put(echo), mesh, ("dp", "sp", None)).contiguous()
    with run.leg(f"pipeline (dp={dp}, sp={sp})"):
        rdm, flags, _ = step(x)
    spec = ("dp", None, "sp")
    rdm, flags = gather_blocks(rdm, mesh, spec), gather_blocks(flags, mesh, spec)
    msg = ""
    if run.root:
        run.check(tuple(rdm.shape) == (n_beams, n_prt, n_pts), f"pipeline rdm {tuple(rdm.shape)}")
        run.check(flags.shape == rdm.shape, "pipeline flags shape")
        with run.checking():
            rdm_u = mtd_produce(run.put(echo), prof)
            flags_u, _ = detect_rdm(rdm, prof, 2, cfg=cfg, renotch_divisor=20)
        run.check(torch.allclose(rdm, rdm_u, rtol=1e-4, atol=1e-3), "sharded RDM != unsharded")
        run.check(torch.equal(flags, flags_u), "sharded != unsharded flags")
        edge = [0, -1]
        run.check(torch.equal(flags[..., edge], flags_u[..., edge]), "phantom edge-column flags")
        run.out.update(pipeline_rdm=rdm, pipeline_flags=flags)
        msg = (f"dryrun_multichip: mesh (dp={dp}, sp={sp}) renotch=20 ok; rdm "
               f"{tuple(rdm.shape)}, cascade hits {int(flags.sum())} (== unsharded, "
               "edge columns clean)")

    # the sharded stream: two windows with the compressed frame carried,
    # the second against one from a freshly recompressed frame
    init, advance = make_sharded_stream(prof, mesh, cfg, n_clutter=2, win_size=WIN_SIZE,
                                        renotch_divisor=20)
    frames = [local_block(run.put(_gaussian(rng, (n_beams, n_prt, n_pts))), mesh,
                          ("dp", "sp", None)).contiguous() for _ in range(3)]
    with run.leg("stream, 2 windows"):
        pc = init(frames[0])
        pc, rdm_w0, flags_w0, _ = advance(pc, frames[1])
        _, rdm_w1, flags_w1, _ = advance(pc, frames[2])
    with run.checking():
        _, rdm_w1f, _, _ = advance(init(frames[1]), frames[2])
    spec = ("dp", None, None, "sp")
    got = [gather_blocks(t, mesh, spec) for t in (rdm_w0, flags_w0, rdm_w1, flags_w1, rdm_w1f)]
    if run.root:
        rdm_w0, flags_w0, rdm_w1, flags_w1, rdm_w1f = got
        # init and step compress in separate calls: held to the JAX
        # package's complex64 tolerance, and whether the bits agree is shown
        run.check(torch.allclose(rdm_w1, rdm_w1f, rtol=1e-3, atol=1e-2), "PC carry != recompress")
        run.check(tuple(rdm_w0.shape) == (n_beams, WIN_SIZE, n_prt, n_pts),
                  f"stream rdm {tuple(rdm_w0.shape)}")
        print("dryrun_multichip: stream: carried PC against recompressed, RDMs "
              + ("bit-identical" if torch.equal(rdm_w1, rdm_w1f) else "within 1e-3"))
        run.out.update(stream_rdm0=rdm_w0, stream_flags0=flags_w0, stream_rdm1=rdm_w1,
                       stream_flags1=flags_w1, stream_rdm1_fresh=rdm_w1f)
        msg += (f"; stream 2 windows ok (hits {int(flags_w0.sum())}, {int(flags_w1.sum())}; "
                "carry==recompress)")

    # the public mesh stream: windows in frame order, hit counters consistent
    prof_stream = dataclasses.replace(prof, prt_per_frame=n_prt, n_beams=n_beams)
    cubes = [np.moveaxis(_gaussian(rng, (n_beams, n_prt, n_pts)), 0, -1) for _ in range(5)]
    pipe = StreamingPipeline(_ArrayReader(cubes), prof_stream, win_size=WIN_SIZE,
                             max_frames=len(cubes), clutter_v=1e-6, max_detections=8,
                             mesh=mesh, device=run.dev)
    with run.leg(f"StreamingPipeline(mesh=), {len(cubes) - 1} windows"):
        windows = list(pipe)
    if run.root:
        run.check([r.frame_idx for r in windows] == list(range(len(cubes) - 1)),
                  "mesh stream emitted windows out of order")
        run.check(all(r.cfar_hits == int(r.flags.sum()) for r in windows),
                  "mesh stream hit counters inconsistent")
        for w, r in enumerate(windows):
            run.out.update({f"streaming_rdm{w}": r.rdms, f"streaming_flags{w}": r.flags})
        msg += f"; mesh StreamingPipeline {len(windows)} windows in order"

    # the 3-axis step from the ingest boundary: tp-sharded DBF, dp frames,
    # sp slow time -> all-to-all -> range halos
    if n_devices % 8 == 0:
        dp3, sp3, tp3 = 2, 2, n_devices // 4
        mesh3 = make_mesh(("dp", "sp", "tp"), (dp3, sp3, tp3), run.dev.type)
        n_ch = n_beams3 = 2 * tp3
        coeffs = _gaussian(rng, (n_beams3, n_ch))
        iq = _gaussian(rng, (dp3, sp3 * 8, n_pts, n_ch))
        step3 = make_sharded_e2e(prof, mesh3, coeffs, CFARConfig(threshold=5.0), n_clutter=2)
        x3 = local_block(run.put(iq), mesh3, ("dp", "sp", None, "tp")).contiguous()
        with run.leg(f"e2e (dp={dp3}, sp={sp3}, tp={tp3})"):
            rdm3, flags3, _ = step3(x3)
        spec = ("dp", "tp", None, "sp")
        rdm3, flags3 = gather_blocks(rdm3, mesh3, spec), gather_blocks(flags3, mesh3, spec)
        if run.root:
            want = (dp3, n_beams3, sp3 * 8, n_pts)
            run.check(tuple(rdm3.shape) == want, f"e2e rdm {tuple(rdm3.shape)}")
            run.check(flags3.shape == rdm3.shape, "e2e flags shape")
            run.out.update(e2e_rdm=rdm3, e2e_flags=flags3)
            msg += (f"; e2e mesh (dp={dp3}, sp={sp3}, tp={tp3}) ok; rdm {tuple(rdm3.shape)}, "
                    f"hits {int(flags3.sum())}")

    if n_devices >= 2:
        msg += _ring_legs(run, rng, n_devices)
    return msg


def _ring_legs(run: _Run, rng: np.random.Generator, n_devices: int) -> str:
    """The stage ring at depths 2-4 and the padded G0 ring on the first 2-4
    ranks, then expert-parallel routing on the first min(4, n)."""
    cfg = CFARConfig(threshold=5.0)
    echo_pp = run.put(_gaussian(rng, (4, 32, 344)))
    msg = ""
    rdms = {}
    for n_pp in (2, 3, 4):
        if n_devices < n_pp:
            continue
        mesh_pp = make_mesh(("pp",), (n_pp,), run.dev.type, ranks=range(n_pp))
        if mesh_pp is None:
            continue
        ring = make_pipeline_parallel(PP_PROFILE, mesh_pp, cfg, n_clutter=4)
        with run.leg(f"pp={n_pp} stage ring"):
            rdm, flags = ring(echo_pp)
        if run.root:
            run.check(tuple(rdm.shape) == (4, 32, 344), f"pp={n_pp} rdm {tuple(rdm.shape)}")
            # the flags of this depth's own RDM, so a flag-plane encoding
            # fault cannot hide behind a good RDM
            want, _ = segmented_cfar(rdm, PP_PROFILE.cfar_segments, cfg, 4)
            run.check(torch.equal(flags, want),
                      f"pp={n_pp} flags diverge from the returned rdm's cascade")
            rdms[n_pp] = rdm
            run.out.update({f"pp{n_pp}_rdm": rdm, f"pp{n_pp}_flags": flags})
            digest = hashlib.sha256(rdm.cpu().numpy().tobytes()
                                    + flags.cpu().numpy().tobytes()).hexdigest()[:12]
            msg += f"; pp={n_pp} stage ring ok, hits {int(flags.sum())}, hash {digest}"
    for n_pp in sorted(rdms)[1:]:
        run.check(torch.allclose(rdms[2], rdms[n_pp], rtol=1e-5, atol=1e-4),
                  f"pp depth {n_pp} diverges numerically from depth 2")

    # the padded G0 profile: a zero-padded unshifted Doppler FFT rides the
    # activation buffer of max(n_pulses, fft_length) rows through the ring
    if n_devices >= 4:
        mesh_g0 = make_mesh(("pp",), (4,), run.dev.type, ranks=range(4))
        echo_g0 = run.put(_gaussian(rng, (5, 48, 160)))
        if mesh_g0 is not None:
            ring = make_pipeline_parallel(G0_PP_PROFILE, mesh_g0, cfg, n_clutter=3)
            with run.leg("g0-pp depth 4"):
                rdm, flags = ring(echo_g0)
            if run.root:
                run.check(tuple(rdm.shape) == (5, 64, 160), f"g0-pp rdm {tuple(rdm.shape)}")
                want, _ = segmented_cfar(rdm, ((0, 160),), cfg, 3)
                run.check(torch.equal(flags, want),
                          "padded-G0 pp flags diverge from the returned rdm's cascade")
                run.out.update(g0pp_rdm=rdm, g0pp_flags=flags)
                msg += f"; g0-pp depth 4 (fft 48->64 unshifted) ok, hits {int(flags.sum())}"

    # per-beam calibration experts, MoE all-to-all dispatch and return
    n_ep = min(4, n_devices)
    mesh_ep = make_mesh(("ep",), (n_ep,), run.dev.type, ranks=range(n_ep))
    n_beams_ep = 2 * n_ep
    cal = (0.5 + rng.random((n_beams_ep, 344))).astype(np.float32)
    frames_ep = _gaussian(rng, (4 * n_ep, 16, 344))
    bids = np.arange(4 * n_ep, dtype=np.int32) % n_beams_ep
    if mesh_ep is not None:
        route = make_expert_parallel(PP_PROFILE, mesh_ep, cal)
        with run.leg(f"ep={n_ep} routing"):
            pc = route(run.put(frames_ep), bids)
        pc = gather_blocks(pc, mesh_ep, ("ep", None, None))
        if run.root:
            run.check(tuple(pc.shape) == frames_ep.shape, f"ep output {tuple(pc.shape)}")
            run.out.update(ep_out=pc)
            msg += f"; ep={n_ep} MoE routing ok"
    return msg


dryrun_multichip.check_launches = {}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m radar_signal_process_tpu_torch.entry",
        description="The multi-device dry run at the world size of the process group "
                    "(run it under torch.distributed.run; one card per rank on cuda).")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

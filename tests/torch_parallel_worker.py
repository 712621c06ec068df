"""Rank body of ``tests/test_torch_parallel.py``: one process of a gloo group
that runs the port's ``parallel`` functions on its own blocks.

Imports torch, numpy and the port only (the parent test computes the JAX
side).  Two forms:

    python tests/torch_parallel_worker.py group NAME RANK WORLD INIT_FILE OUT_DIR
    python -m torch.distributed.run --standalone --nproc_per_node N \\
        tests/torch_parallel_worker.py cli OUT_PREFIX -- CLI_ARGS...

``group`` joins a gloo group through ``INIT_FILE`` (``file://``, so parallel
test workers never share a port) and runs every case of group ``NAME``;
rank 0 writes each case's gathered outputs to ``OUT_DIR/<case>.npz``.
``cli`` runs ``radar_signal_process_tpu_torch.cli`` under ``torchrun`` with
the test profiles registered and writes each rank's standard output to
``OUT_PREFIX.<rank>``.  The inputs are built here from seeds, so the parent
builds the same ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.config import G0_PROFILE, G2_PROFILE, CFARConfig, MTDConfig

SEG3 = dict(point_prt=344, segment_points=(24, 80, 240), cfar_segments=((0, 24), (24, 104), (104, 344)))
# profiles of the cases (the JAX tests' reduced geometries)
TINY344 = dataclasses.replace(G2_PROFILE, prt_per_frame=32, n_beams=2, **SEG3)
STREAM64 = dataclasses.replace(G2_PROFILE, prt_per_frame=64, **SEG3)
ISTC = dataclasses.replace(
    TINY344, mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150, fftshift=True,
                           istc=True))
E2E = dataclasses.replace(TINY344, n_channels=4, n_beams=4)
E2E_STALE = dataclasses.replace(E2E, cfar_segments=((0, 24), (24, 104), (104, 400)))
MTI = dataclasses.replace(
    TINY344, mtd=MTDConfig(window="kaiser", window_beta=8.0, notch_divisor=150, fftshift=True,
                           mti_lag=5))
G0_SMALL = dataclasses.replace(
    G0_PROFILE, prt_per_frame=48, point_prt=160, segment_points=(32, 128),
    mtd=MTDConfig(window="hamming", notch_divisor=0, fft_length=64, fftshift=False))
EP = dataclasses.replace(G2_PROFILE, prt_per_frame=16, **SEG3)
# the CLI parity captures (JAX tests/test_cli.py TINYM / TINYS: 2 channels)
CLI_PROFILE = dataclasses.replace(TINY344, n_channels=2)
CLI_PROFILES = {"TINYM": CLI_PROFILE, "TINYS": CLI_PROFILE}

CFG_57 = CFARConfig(ref_cells=5, guard_cells=7, threshold=5.0)
CFG_T5 = CFARConfig(threshold=5.0)
SEGMENTS_160 = ((0, 24), (24, 88), (88, 160))
STC = np.linspace(0.0, 6.0, 100)


def rng_of(case: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, case)) * 7919)


def cplx(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def rdm_input(rng, nv=96, nr=160, hits=12) -> np.ndarray:
    """A float32 RDM with strong cells, some on the shard and segment edges."""
    rdm = (np.abs(rng.standard_normal((nv, nr))) + 0.5).astype(np.float32)
    for _ in range(hits):
        rdm[rng.integers(8, nv - 8), rng.integers(0, nr)] += 40.0
    for c in (0, 23, 24, 39, 40, 41, 79, 80, 87, 88, 119, 120, nr - 1):
        rdm[rng.integers(8, nv - 8), c] += 40.0
    return rdm


def echo_with_targets(rng, shape, cells=(100, 300, 1004)) -> np.ndarray:
    """Complex noise with a few moving point returns (columns clipped to the
    fast-time width), so the CFAR has hits to find."""
    x = cplx(rng, shape)
    n_prt, n_pts = shape[-2], shape[-1]
    ramp = np.exp(2j * np.pi * 0.2 * np.arange(n_prt))[:, None]
    for k, c in enumerate(cells):
        x[..., :, c % n_pts : c % n_pts + 1] += (30.0 + 10 * k) * ramp
    return x.astype(np.complex64)


def frames_input(case: str, profile, n_beams: int, n_frames: int) -> list:
    rng = rng_of(case)
    shape = (n_beams, profile.prt_per_frame, profile.point_prt)
    m = np.arange(n_frames * shape[1]).reshape(n_frames, shape[1])
    out = []
    for f in range(n_frames):
        x = cplx(rng, shape)
        x[..., 60] += 40.0 * np.exp(2j * np.pi * 0.23 * m[f])[None, :]
        out.append(x)
    return out


def pulses_for(profile):
    from radar_signal_process_tpu_torch.ops.waveforms import pulses_with_overrides

    wf = np.exp(1j * np.pi * np.linspace(-1, 1, 40) ** 2) * 1.1
    return pulses_with_overrides(profile, {1: wf})


def e2e_input(case: str):
    rng = rng_of(case)
    iq = cplx(rng, (2, 32, 344, 4))
    iq[:, :, 200, :] += 30.0 * np.exp(2j * np.pi * 0.2 * np.arange(32))[None, :, None]
    coeffs = (rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))).astype(np.complex64)
    return iq, coeffs


def ep_input(case: str, n_beams: int, n_frames: int, n_prt: int):
    rng = rng_of(case)
    cal = (0.5 + rng.random((n_beams, EP.point_prt))).astype(np.float32)
    frames = cplx(rng, (n_frames, n_prt, EP.point_prt))
    return cal, frames


class FrameReader:
    """``read_frame`` over in-memory (beams, prt, samples) frames, in the
    readers' (prt, samples, beams) layout."""

    def __init__(self, frames):
        self.frames = frames

    def read_frame(self, idx):
        from radar_signal_process_tpu_torch.ingest import FrameResult

        done = idx < len(self.frames)
        iq = np.moveaxis(self.frames[idx], 0, -1) if done else None
        return FrameResult(iq, None, done, not done, {})


# --------------------------------------------------------------------- cases
def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return None if x is None else x.numpy()


def case_ref_level(mesh, case):
    from radar_signal_process_tpu_torch.parallel.sharding import (
        gather_blocks, local_block, sharded_cfar1d_ref_level)

    data = (np.abs(rng_of(case).standard_normal((32, 128))) + 0.1).astype(np.float32)
    got = sharded_cfar1d_ref_level(local_block(_t(data), mesh, (None, "sp")), CFG_57, mesh,
                                   "sp", 128)
    return {"ref": _np(gather_blocks(got, mesh, (None, "sp")))}


def _cascade(mesh, case, segments=(), cfg=CFG_57):
    from radar_signal_process_tpu_torch.parallel.sharding import (
        gather_blocks, local_block, sharded_cascaded_cfar2d)

    rdm = rdm_input(rng_of(case))
    f, v = sharded_cascaded_cfar2d(local_block(_t(rdm), mesh, (None, "sp")), cfg, 6, mesh,
                                   "sp", 160, segments)
    return {"flags": _np(gather_blocks(f, mesh, (None, "sp"))),
            "vflags": _np(gather_blocks(v, mesh, (None, "sp")))}


def case_cascade(mesh, case):
    return _cascade(mesh, case)


def case_segcascade(mesh, case):
    return _cascade(mesh, case, SEGMENTS_160)


def case_segcascade_e3(mesh, case):
    return _cascade(mesh, case, SEGMENTS_160, dataclasses.replace(CFG_57, range_extend_cells=3))


def case_pipeline(mesh, case):
    from radar_signal_process_tpu_torch.parallel import make_sharded_pipeline
    from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks, local_block

    echo = echo_with_targets(rng_of(case), (2, 64, G2_PROFILE.point_prt))
    run = make_sharded_pipeline(G2_PROFILE, mesh, CFG_57, 6)
    out = run(local_block(_t(echo), mesh, ("dp", "sp", None)).contiguous())
    return {k: _np(gather_blocks(x, mesh, ("dp", None, "sp")))
            for k, x in zip(("rdm", "flags", "vflags"), out)}


def case_renotch(mesh, case):
    from radar_signal_process_tpu_torch.parallel import make_sharded_pipeline
    from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks, local_block

    echo = cplx(rng_of(case), (2, 32, 344))
    run = make_sharded_pipeline(TINY344, mesh, CFG_T5, 4, renotch_divisor=20)
    rdm, flags, _ = run(local_block(_t(echo), mesh, ("dp", "sp", None)).contiguous())
    return {"rdm": _np(gather_blocks(rdm, mesh, ("dp", None, "sp"))),
            "flags": _np(gather_blocks(flags, mesh, ("dp", None, "sp")))}


def _stream(mesh, case, profile, n_frames, cfg, n_clutter, **hooks):
    from radar_signal_process_tpu_torch.parallel.sharding import (
        gather_blocks, local_block, make_sharded_stream)

    frames = frames_input(case, profile, 2, n_frames)
    init, step = make_sharded_stream(profile, mesh, cfg, n_clutter, win_size=4,
                                     renotch_divisor=20, **hooks)
    spec = ("dp", "sp", None)
    pc = init(local_block(_t(frames[0]), mesh, spec).contiguous())
    out = {}
    for w in range(n_frames - 1):
        pc, rdm, flags, vflags = step(pc, local_block(_t(frames[w + 1]), mesh, spec).contiguous())
        for k, x in (("rdm", rdm), ("flags", flags), ("vflags", vflags)):
            out[f"{k}{w}"] = _np(gather_blocks(x, mesh, ("dp", None, None, "sp")))
    return out


def case_stream(mesh, case):
    return _stream(mesh, case, STREAM64, 4, CFG_57, 6)


def case_istc(mesh, case):
    return _stream(mesh, case, ISTC, 3, CFG_T5, 4, stc_curve_db=STC, pulses=pulses_for(ISTC))


def case_stream_pipeline(mesh, case):
    """``StreamingPipeline(mesh=...)`` against the unsharded one, same frames."""
    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline

    frames = frames_input(case, TINY344, 3, 4)     # 3 beams: dp pads them
    kw = dict(win_size=4, max_frames=4, clutter_v=3.0, max_detections=8, device="cpu")
    got = list(StreamingPipeline(FrameReader(frames), TINY344, mesh=mesh, **kw))
    out = {"n_windows": np.asarray(len(got))}
    if dist.get_rank() != 0:
        assert all(r.rdms is None and r.detections is None for r in got)
        return out
    want = list(StreamingPipeline(FrameReader(frames), TINY344, **kw))
    assert [r.frame_idx for r in got] == [r.frame_idx for r in want]
    for w, (g, u) in enumerate(zip(got, want)):
        out.update({f"rdm{w}": _np(g.rdms), f"flags{w}": _np(g.flags), f"hits{w}":
                    np.asarray(g.cfar_hits), f"want_rdm{w}": _np(u.rdms),
                    f"want_flags{w}": _np(u.flags), f"want_hits{w}": np.asarray(u.cfar_hits),
                    f"det_valid{w}": _np(g.detections.valid), f"det_v{w}": _np(g.detections.v_idx),
                    f"det_r{w}": _np(g.detections.r_idx)})
    return out


def _e2e(mesh, case, profile):
    from radar_signal_process_tpu_torch.parallel import make_sharded_e2e
    from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks, local_block

    iq, coeffs = e2e_input(case)
    run = make_sharded_e2e(profile, mesh, coeffs, CFARConfig(ref_cells=3, guard_cells=4,
                                                            threshold=5.0), n_clutter=4)
    out = run(local_block(_t(iq), mesh, ("dp", "sp", None, "tp")).contiguous())
    return {k: _np(gather_blocks(x, mesh, ("dp", "tp", None, "sp")))
            for k, x in zip(("rdm", "flags", "vflags"), out)}


def case_e2e(mesh, case):
    return _e2e(mesh, case, E2E)


def case_e2e_stale(mesh, case):
    return _e2e(mesh, case, E2E_STALE)


def _pp(mesh, case, profile, shape, n_clutter):
    from radar_signal_process_tpu_torch.parallel import make_pipeline_parallel

    echo = cplx(rng_of(case), shape)
    rdm, flags = make_pipeline_parallel(profile, mesh, CFG_T5, n_clutter=n_clutter)(_t(echo))
    return {"rdm": _np(rdm), "flags": _np(flags)}


def case_pp(mesh, case):
    return _pp(mesh, case, TINY344, (5, 64, 344), 4)


def case_pp_g0(mesh, case):
    return _pp(mesh, case, G0_SMALL, (5, 48, 160), 3)


def case_pp_mti(mesh, case):
    return _pp(mesh, case, MTI, (4, 32, 344), 4)


def case_ep(mesh, case):
    from radar_signal_process_tpu_torch.parallel import make_expert_parallel
    from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks

    n_ep = mesh.size()
    capacity = 1 if n_ep == 2 else None
    n_beams, n_frames, n_prt = (4, 8, 8) if n_ep == 2 else (8, 16, 16)
    cal, frames = ep_input(case, n_beams, n_frames, n_prt)
    # two ranks: every frame to the second rank's beams, capacity 1 (drops);
    # four: the beams balanced, nothing drops
    ids = np.full(n_frames, 2) if n_ep == 2 else np.arange(n_frames) % n_beams
    run = make_expert_parallel(EP, mesh, cal, capacity=capacity)
    out = {"out": _np(gather_blocks(run(_t(frames), ids), mesh, ("ep", None, None)))}
    try:
        run(_t(frames), np.where(np.arange(n_frames) == 3, n_beams, ids))
    except ValueError as e:
        out["bad_ids_error"] = np.asarray(str(e))
    return out


def case_multihost(mesh, case):
    from radar_signal_process_tpu_torch.parallel.multihost import (
        host_frame_assignment, initialize_distributed)

    rank, world = initialize_distributed("cpu")         # joins the group as it is
    ranges = [list(host_frame_assignment(10)), list(host_frame_assignment(10, 0, 2)),
              list(host_frame_assignment(10, 1, 2))]
    got = gather_rows(np.asarray([rank, world] + ranges[0] + [-1] * (12 - len(ranges[0]))))
    return {"rows": got, "two_hosts_a": np.asarray(ranges[1]), "two_hosts_b": np.asarray(ranges[2])}


def gather_rows(row: np.ndarray):
    parts = [torch.empty(row.shape, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, torch.from_numpy(row.astype(np.int64)))
    return np.stack([p.numpy() for p in parts])


# group -> [(case name, mesh axes, mesh shape, case function)]
GROUPS = {
    "w4": [
        ("ref_level-2x2", ("dp", "sp"), (2, 2), case_ref_level),
        ("ref_level-1x4", ("dp", "sp"), (1, 4), case_ref_level),
        ("cascade-2x2", ("dp", "sp"), (2, 2), case_cascade),
        ("cascade-1x4", ("dp", "sp"), (1, 4), case_cascade),
        ("segcascade-2x2", ("dp", "sp"), (2, 2), case_segcascade),
        ("segcascade-1x4", ("dp", "sp"), (1, 4), case_segcascade),
        ("segcascade_e3-1x4", ("dp", "sp"), (1, 4), case_segcascade_e3),
        ("pipeline-2x2", ("dp", "sp"), (2, 2), case_pipeline),
        ("pipeline-1x4", ("dp", "sp"), (1, 4), case_pipeline),
        ("renotch-2x2", ("dp", "sp"), (2, 2), case_renotch),
        ("renotch-1x4", ("dp", "sp"), (1, 4), case_renotch),
        ("stream-2x2", ("dp", "sp"), (2, 2), case_stream),
        ("stream-1x4", ("dp", "sp"), (1, 4), case_stream),
        ("istc-2x2", ("dp", "sp"), (2, 2), case_istc),
        ("stream_pipeline-2x2", ("dp", "sp"), (2, 2), case_stream_pipeline),
        ("e2e-1x2x2", ("dp", "sp", "tp"), (1, 2, 2), case_e2e),
        ("e2e_stale-1x2x2", ("dp", "sp", "tp"), (1, 2, 2), case_e2e_stale),
        ("pp-4", ("pp",), (4,), case_pp),
        ("pp_g0-4", ("pp",), (4,), case_pp_g0),
        ("ep-4", ("ep",), (4,), case_ep),
        ("multihost-4", ("dp",), (4,), case_multihost),
    ],
    "w3": [
        ("pp-3", ("pp",), (3,), case_pp),
        ("pp_mti-3", ("pp",), (3,), case_pp_mti),
    ],
    "w2": [
        ("pp-2", ("pp",), (2,), case_pp),
        ("pp_g0-2", ("pp",), (2,), case_pp_g0),
        ("ep-2", ("ep",), (2,), case_ep),
        ("multihost-2", ("dp",), (2,), case_multihost),
    ],
}


def run_group(name: str, rank: int, world: int, init_file: str, out_dir: str) -> None:
    from radar_signal_process_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        for case, axes, shape, fn in GROUPS[name]:
            with torch.inference_mode():
                out = fn(make_mesh(axes, shape, "cpu"), case)
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{case}.npz"), **out)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def run_cli(out_prefix: str, argv: list) -> None:
    from radar_signal_process_tpu_torch import cli

    torch.set_num_threads(1)
    tconfig.PROFILES.update(CLI_PROFILES)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    with open(f"{out_prefix}.{os.environ['RANK']}", "w") as fh:
        fh.write(buf.getvalue())
    sys.exit(rc)


if __name__ == "__main__":
    if sys.argv[1] == "group":
        run_group(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6])
    else:
        run_cli(sys.argv[2], sys.argv[sys.argv.index("--") + 1:])

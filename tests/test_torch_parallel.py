"""The port's multi-device layer (``radar_signal_process_tpu_torch.parallel``)
against the JAX package's ``parallel``.

The port's side runs in gloo groups of 2, 3 and 4 processes
(``tests/torch_parallel_worker.py``: torch, numpy and the port only), and the
CLI's ``--mesh`` under ``torchrun``; all of them start together once per
module and write their gathered outputs to ``tmp_path``.  This process
computes the JAX side on the 8-device CPU mesh of ``tests/conftest.py``,
at the same mesh shapes, from the same seeded numpy inputs (complex64 /
float32), and compares case by case.

Tolerances: CFAR flags on one RDM are bit-identical (each rank of the port
runs B1's plain version on its halo-extended block, the card's route; the
JAX package runs the roll form; above the parity floor of ROADMAP C3 both
give the unsharded op's flags).  RDMs and compressed pulses of the two FFT and
GEMM libraries agree to ``RTOL`` and ``PEAK_ATOL`` of the peak, the f32
tolerance of ``test_torch_slice.py`` (the JAX tests' 1e-9 holds for x64
only); flags downstream of an RDM are held by rerunning the CFAR of both
packages on the port's RDM (ROADMAP C5).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.models.detect import detect_rdm as jdetect_rdm
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.parallel import make_mesh as jmake_mesh
from radar_signal_process_tpu.parallel import mesh as jmesh
from radar_signal_process_tpu.parallel import multihost as jmultihost
from radar_signal_process_tpu.parallel import sharding as jsharding
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch.kernels.cfar import extended_segments
from radar_signal_process_tpu_torch.models import detect as tdetect
from radar_signal_process_tpu_torch.ops import cfar as tcfar
from radar_signal_process_tpu_torch.parallel import mesh as tmesh
from radar_signal_process_tpu_torch.parallel import multihost as tmultihost
from radar_signal_process_tpu_torch.parallel import sharding as tsharding
from tests import torch_parallel_worker as W
from tests.test_torch_import import as_config

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
RTOL, PEAK_ATOL = 2e-4, 2e-5
WORLDS = {"w4": 4, "w3": 3, "w2": 2}
E2E_ARGS = ["e2e", "--profile", "TINYM", "--frames", "2", "--beam", "0", "--win-slice", "1"]
STREAM_ARGS = ["stream", "--profile", "TINYS", "--frames", "4", "--win-size", "2"]


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


class Runs:
    """The module's process groups, started together, awaited on first use."""

    def __init__(self, root: pathlib.Path):
        self.root = root
        self.procs = {}
        self.done = {}
        for name, world in WORLDS.items():
            d = root / name
            d.mkdir()
            self.procs[name] = [subprocess.Popen(
                [sys.executable, str(WORKER), "group", name, str(r), str(world),
                 str(d / "init"), str(d)],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)]
        # the CLI captures: JAX tests/test_cli.py's TINYM e2e and TINYS stream scenes
        from radar_signal_process_tpu_torch import cli as tcli

        tconfig.PROFILES.update(W.CLI_PROFILES)
        for name, scene in (("e2e", ["--frames", "3", "--velocity", "-5.7"]),
                            ("stream", ["--frames", "4", "--velocity", "4.0"])):
            assert tcli.main(["simulate", "--output", str(root / f"cap_{name}"), "--profile",
                              "TINYM", "--range", "60", "--scr", "25", *scene]) == 0
        for name, argv, n in (("e2e", E2E_ARGS + ["--mesh", "2x2"], 4),
                              ("stream", STREAM_ARGS + ["--mesh", "1x2"], 2)):
            argv = argv + ["--input", str(root / f"cap_{name}"), "--device", "cpu"]
            self.procs[f"cli_{name}"] = [subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", str(n), str(WORKER), "cli", str(root / f"cli_{name}"),
                 "--", *argv],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)]

    def wait(self, name: str):
        if name not in self.done:
            logs = []
            for p in self.procs[name]:
                try:
                    out, _ = p.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    self.close()
                    raise
                logs.append(out)
            failed = [log for p, log in zip(self.procs[name], logs) if p.returncode != 0]
            self.done[name] = "\n".join(failed)[-6000:]
        assert not self.done[name], f"{name} ranks failed:\n{self.done[name]}"

    def case(self, name: str) -> dict:
        group = next(g for g, cases in W.GROUPS.items() if any(c[0] == name for c in cases))
        self.wait(group)
        with np.load(self.root / group / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}

    def cli(self, name: str, n: int) -> list:
        self.wait(f"cli_{name}")
        return [(self.root / f"cli_{name}.{r}").read_text() for r in range(n)]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("torch_parallel"))
    yield r
    r.close()
    for name in W.CLI_PROFILES:
        tconfig.PROFILES.pop(name, None)


def _jmesh(axes, shape):
    return jmake_mesh(axes, shape=shape, devices=jax.devices()[: int(np.prod(shape))])


def _jshard(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs))


def _j(prof):
    return as_config(prof, jconfig)


def _jcfg(cfg):
    return as_config(cfg, jconfig)


def _assert_close(got, want):
    """f32 agreement relative to the peak (``test_torch_slice.py``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL, atol=PEAK_ATOL)


def _mesh_shape(case):
    return tuple(int(x) for x in case.split("-")[1].split("x"))


# ------------------------------------------------------------- halo CFAR
@pytest.mark.parametrize("case", ["ref_level-2x2", "ref_level-1x4"])
def test_sharded_ref_level_matches_jax(runs, case):
    data = (np.abs(W.rng_of(case).standard_normal((32, 128))) + 0.1).astype(np.float32)
    mesh = _jmesh(("dp", "sp"), _mesh_shape(case))
    want = _jshard(lambda x: jsharding.sharded_cfar1d_ref_level(x, _jcfg(W.CFG_57), "sp", 128),
                   mesh, P(None, "sp"), P(None, "sp"))(jnp.asarray(data))
    got = runs.case(case)["ref"]
    np.testing.assert_array_equal(
        got, tcfar.cfar1d_ref_level(torch.from_numpy(data), 5, 7, 0, dim=-1).numpy())
    # XLA may round the window mean's division one ulp apart from IEEE
    # division; the flags of the cascades below are held bit for bit
    np.testing.assert_allclose(got, np.asarray(want), rtol=2.5e-7, atol=0)


@pytest.mark.parametrize("case", ["cascade-2x2", "cascade-1x4", "segcascade-2x2",
                                  "segcascade-1x4", "segcascade_e3-1x4"])
def test_sharded_cascade_matches_jax(runs, case):
    """Flags bit for bit against the JAX sharded cascade and the port's
    ``segmented_cfar`` over the whole RDM; ``segcascade`` cuts the segments
    off the shard boundaries (shard width 80 or 40)."""
    rdm = W.rdm_input(W.rng_of(case))
    segments = () if case.startswith("cascade") else W.SEGMENTS_160
    cfg = W.CFG_57
    if "e3" in case:
        cfg = dataclasses.replace(cfg, range_extend_cells=3)
    mesh = _jmesh(("dp", "sp"), _mesh_shape(case))
    jf, jv = _jshard(
        lambda x: jsharding.sharded_cascaded_cfar2d(x, _jcfg(cfg), 6, "sp", 160, segments),
        mesh, P(None, "sp"), (P(None, "sp"), P(None, "sp")))(jnp.asarray(rdm))
    tf, tv = tcfar.segmented_cfar(torch.from_numpy(rdm), segments or ((0, 160),), cfg, 6)
    got = runs.case(case)
    assert got["flags"].any()
    for k, j, t in (("flags", jf, tf), ("vflags", jv, tv)):
        np.testing.assert_array_equal(got[k], np.asarray(j))
        np.testing.assert_array_equal(got[k], t.numpy())


# ------------------------------------------------------------- chains
def _rerun_flags(rdm, profile, cfg, n_clutter, renotch=None):
    """Flags of both packages' CFAR rerun on one RDM: (port, JAX); a stale
    segment table runs whole-width, as the sharded chains do."""
    segs = tsharding._cfar_segments(profile, True) or ((0, rdm.shape[-1]),)
    x = rdm
    if renotch:
        x = rdm * tdetect.renotch_mask(profile, rdm.shape[-2], n_clutter, renotch)[:, None]
    tf, _ = tcfar.segmented_cfar(torch.from_numpy(np.ascontiguousarray(x)), segs, cfg, n_clutter)
    jf, _ = jcfar.segmented_cfar(jnp.asarray(x), segs, _jcfg(cfg), n_clutter)
    return tf.numpy(), np.asarray(jf)


@pytest.mark.parametrize("case", ["pipeline-2x2", "pipeline-1x4"])
def test_sharded_pipeline_matches_jax(runs, case):
    """PRT-sharded PC -> all-to-all -> range-sharded B2 + halo CFAR at the
    full G2 fast-time width: RDMs to the f32 tolerance of the JAX sharded
    pipeline and of the port's unsharded ``mtd_produce``; flags equal the
    CFAR of either package rerun on the returned RDM."""
    from radar_signal_process_tpu_torch.models.mtd_pipeline import mtd_produce

    echo = W.echo_with_targets(W.rng_of(case), (2, 64, W.G2_PROFILE.point_prt))
    mesh = _jmesh(("dp", "sp"), _mesh_shape(case))
    run = jsharding.make_sharded_pipeline(_j(W.G2_PROFILE), mesh, _jcfg(W.CFG_57), 6)
    j_rdm, j_flags, _ = run(jax.device_put(jnp.asarray(echo), NamedSharding(mesh, P("dp", "sp"))))
    got = runs.case(case)
    _assert_close(got["rdm"], j_rdm)
    _assert_close(got["rdm"], mtd_produce(torch.from_numpy(echo), W.G2_PROFILE).numpy())
    tf, jf = _rerun_flags(got["rdm"], W.G2_PROFILE, W.CFG_57, 6)
    assert got["flags"].any()
    np.testing.assert_array_equal(got["flags"], tf)
    np.testing.assert_array_equal(got["flags"], jf)
    np.testing.assert_array_equal(got["flags"], np.asarray(j_flags))


@pytest.mark.parametrize("case", ["renotch-2x2", "renotch-1x4"])
def test_sharded_pipeline_renotch_no_phantom_edge_flags(runs, case):
    """Re-notched all-zero rows self-flag (C8), in the wrapped halo too: a
    phantom winner there would mark real edge columns.  The flags equal
    ``detect_rdm`` of both packages on the returned RDM."""
    got = runs.case(case)
    rdm = got["rdm"]
    tf, _ = tdetect.detect_rdm(torch.from_numpy(rdm), W.TINY344, 4, cfg=W.CFG_T5)
    jf, _ = jdetect_rdm(jnp.asarray(rdm), _j(W.TINY344), 4, cfg=_jcfg(W.CFG_T5))
    np.testing.assert_array_equal(got["flags"], tf.numpy())
    np.testing.assert_array_equal(got["flags"], np.asarray(jf))
    assert got["flags"].sum() > 0
    echo = W.cplx(W.rng_of(case), (2, 32, 344))
    mesh = _jmesh(("dp", "sp"), _mesh_shape(case))
    run = jsharding.make_sharded_pipeline(_j(W.TINY344), mesh, _jcfg(W.CFG_T5), n_clutter=4,
                                          renotch_divisor=20)
    j_rdm, _, _ = run(jax.device_put(jnp.asarray(echo), NamedSharding(mesh, P("dp"))))
    _assert_close(rdm, j_rdm)


def _jax_stream(case, profile, n_frames, cfg, n_clutter, **hooks):
    frames = W.frames_input(case, profile, 2, n_frames)
    mesh = _jmesh(("dp", "sp"), _mesh_shape(case))
    init, step = jsharding.make_sharded_stream(_j(profile), mesh, _jcfg(cfg), n_clutter,
                                               win_size=4, renotch_divisor=20, **hooks)
    sh = NamedSharding(mesh, P("dp", "sp", None))
    pc = init(jax.device_put(jnp.asarray(frames[0]), sh))
    out = []
    for w in range(n_frames - 1):
        pc, rdm, flags, _ = step(pc, jax.device_put(jnp.asarray(frames[w + 1]), sh))
        out.append((np.asarray(rdm), np.asarray(flags)))
    return out


@pytest.mark.parametrize("case", ["stream-2x2", "stream-1x4"])
def test_sharded_stream_matches_jax(runs, case):
    """Three windows over four frames with the compressed frame carried:
    RDMs to the f32 tolerance of the JAX sharded stream, flags and vflags
    equal to the re-notched CFAR rerun on them."""
    got = runs.case(case)
    for w, (j_rdm, j_flags) in enumerate(_jax_stream(case, W.STREAM64, 4, W.CFG_57, 6)):
        rdm = got[f"rdm{w}"]
        assert rdm.shape == (2, 4, 64, 344)
        _assert_close(rdm, j_rdm)
        tf, jf = _rerun_flags(rdm, W.STREAM64, W.CFG_57, 6, renotch=20)
        np.testing.assert_array_equal(got[f"flags{w}"], tf)
        np.testing.assert_array_equal(got[f"flags{w}"], jf)
        np.testing.assert_array_equal(got[f"flags{w}"], j_flags)


def test_sharded_stream_istc_and_measured_pulses(runs):
    case = "istc-2x2"
    from radar_signal_process_tpu.ops.waveforms import pulses_with_overrides

    wf = np.exp(1j * np.pi * np.linspace(-1, 1, 40) ** 2) * 1.1
    want = _jax_stream(case, W.ISTC, 3, W.CFG_T5, 4, stc_curve_db=W.STC,
                       pulses=pulses_with_overrides(_j(W.ISTC), {1: wf}))
    got = runs.case(case)
    for w, (j_rdm, _) in enumerate(want):
        _assert_close(got[f"rdm{w}"], j_rdm)
        tf, _ = _rerun_flags(got[f"rdm{w}"], W.ISTC, W.CFG_T5, 4, renotch=20)
        np.testing.assert_array_equal(got[f"flags{w}"], tf)


def test_streaming_pipeline_mesh_matches_unsharded(runs):
    """``StreamingPipeline(mesh=2x2)`` (3 beams padded to dp, frames over a
    reader) against the port's unsharded pipeline on the same frames; rank 0
    yields the stacks and detections, the other ranks ``None``."""
    got = runs.case("stream_pipeline-2x2")
    assert int(got["n_windows"]) == 3
    n_clutter = tdetect.clutter_cells(W.TINY344, 32, 3.0)
    det = tdetect.make_detector(W.TINY344, n_clutter=n_clutter, max_detections=8, device="cpu")
    for w in range(3):
        rdm = got[f"rdm{w}"]
        assert rdm.shape == (3, 4, 32, 344)
        _assert_close(rdm, got[f"want_rdm{w}"])
        flags, _, dets = det(torch.from_numpy(rdm))
        np.testing.assert_array_equal(got[f"flags{w}"], flags.numpy())
        assert int(got[f"hits{w}"]) == int(flags.sum()) > 0
        np.testing.assert_array_equal(got[f"det_valid{w}"], dets.valid.numpy())
        v = dets.valid.numpy()
        np.testing.assert_array_equal(got[f"det_r{w}"][v], dets.r_idx.numpy()[v])


@pytest.mark.parametrize("case", ["e2e-1x2x2", "e2e_stale-1x2x2"])
def test_sharded_e2e_tp_dbf_matches_jax(runs, case):
    """(dp, sp, tp) = (1, 2, 2): the tp DBF's reduce-scatter sums channels in
    another order than one einsum, so RDMs compare to the f32 tolerance and
    flags by rerunning the CFAR; a stale segment table runs whole-width."""
    prof = W.E2E if case.startswith("e2e-") else W.E2E_STALE
    iq, coeffs = W.e2e_input(case)
    cfg = jconfig.CFARConfig(ref_cells=3, guard_cells=4, threshold=5.0)
    mesh = _jmesh(("dp", "sp", "tp"), (1, 2, 2))
    run = jsharding.make_sharded_e2e(_j(prof), mesh, coeffs, cfg, n_clutter=4)
    j_rdm, _, _ = run(jax.device_put(jnp.asarray(iq), NamedSharding(mesh, P("dp", "sp", None, "tp"))))
    got = runs.case(case)
    assert got["rdm"].shape == (2, 4, 32, 344)
    _assert_close(got["rdm"], j_rdm)
    tf, jf = _rerun_flags(got["rdm"], prof, as_config(cfg, tconfig), 4)
    if prof is W.E2E_STALE:
        jf, _ = jcfar.cascaded_cfar2d(jnp.asarray(got["rdm"]), cfg, 4)
    np.testing.assert_array_equal(got["flags"], tf)
    np.testing.assert_array_equal(got["flags"], np.asarray(jf))
    assert got["flags"].any()


# ------------------------------------------------------ pipeline / expert
_PP = {"pp": (W.TINY344, (5, 64, 344), 4), "pp_g0": (W.G0_SMALL, (5, 48, 160), 3),
       "pp_mti": (W.MTI, (4, 32, 344), 4)}


@pytest.mark.parametrize("case", ["pp-2", "pp-3", "pp-4", "pp_g0-2", "pp_g0-4", "pp_mti-3"])
def test_pipeline_parallel_matches_jax(runs, case):
    """The stage ring at depth 2, 3 and 4 (depth 4 splits the cascade at its
    flag planes): RDMs to the f32 tolerance of the JAX ring, flags equal to
    both packages' CFAR rerun on the returned RDM."""
    kind, depth = case.split("-")
    prof, shape, n_clutter = _PP[kind]
    echo = W.cplx(W.rng_of(case), shape)
    mesh = jmake_mesh(("pp",), shape=(int(depth),), devices=jax.devices()[: int(depth)])
    j_rdm, _ = jsharding.make_pipeline_parallel(_j(prof), mesh, _jcfg(W.CFG_T5),
                                                n_clutter=n_clutter)(jnp.asarray(echo))
    got = runs.case(case)
    _assert_close(got["rdm"], j_rdm)
    tf, jf = _rerun_flags(got["rdm"], prof, W.CFG_T5, n_clutter)
    np.testing.assert_array_equal(got["flags"], tf)
    np.testing.assert_array_equal(got["flags"], jf)


@pytest.mark.parametrize("case", ["ep-4", "ep-2"])
def test_expert_parallel_matches_jax(runs, case):
    """MoE-routed calibration experts: balanced beams on four ranks route
    every frame; on two, capacity 1 drops all but the first frame of each
    source rank to zeros, as the JAX package does.  Bad ids raise on every
    rank."""
    n_ep = int(case.split("-")[1])
    n_beams, n_frames, n_prt = (4, 8, 8) if n_ep == 2 else (8, 16, 16)
    cal, frames = W.ep_input(case, n_beams, n_frames, n_prt)
    ids = np.full(n_frames, 2) if n_ep == 2 else np.arange(n_frames) % n_beams
    mesh = jmake_mesh(("ep",), shape=(n_ep,), devices=jax.devices()[:n_ep])
    run = jsharding.make_expert_parallel(_j(W.EP), mesh, cal, capacity=1 if n_ep == 2 else None)
    want = np.asarray(run(jnp.asarray(frames), jnp.asarray(ids, dtype=jnp.int32)))
    got = runs.case(case)
    kept = np.abs(want).reshape(n_frames, -1).max(axis=1) > 0
    assert kept.sum() == (2 if n_ep == 2 else n_frames)
    assert not got["out"][~kept].any()
    _assert_close(got["out"][kept], want[kept])
    assert "out of range" in str(got["bad_ids_error"])


@pytest.mark.parametrize("case", ["multihost-4", "multihost-2"])
def test_multihost_helpers_in_a_group(runs, case):
    """``initialize_distributed`` joins the running group; the default frame
    ranges are this rank's of the world, as the JAX helper's for that
    process id."""
    world = int(case.split("-")[1])
    got = runs.case(case)
    for rank, row in enumerate(got["rows"]):
        want = list(jmultihost.host_frame_assignment(10, rank, world))
        assert list(row[:2]) == [rank, world]
        assert [x for x in row[2:] if x >= 0] == want
    assert list(got["two_hosts_a"]) == [0, 1, 2, 3, 4, 5]
    assert list(got["two_hosts_b"]) == [5, 6, 7, 8, 9]


# ------------------------------------------------------------- pure pieces
@pytest.mark.parametrize("n_axes", [1, 2, 3])
def test_best_mesh_shape_and_frame_assignment_equal_jax(n_axes):
    for n in range(1, 33):
        assert tmesh.best_mesh_shape(n, n_axes) == jmesh.best_mesh_shape(n, n_axes)
    for n_frames in (1, 2, 7, 10, 33):
        for world in range(1, 6):
            for pid in range(world):
                assert (list(tmultihost.host_frame_assignment(n_frames, pid, world))
                        == list(jmultihost.host_frame_assignment(n_frames, pid, world)))
    assert list(tmultihost.host_frame_assignment(5)) == [0, 1, 2, 3, 4]


_TABLES = {"g2": ((0, 228), (228, 951), (951, 3404)), "seg3": W.SEG3["cfar_segments"],
           "one": ((0, 344),)}


@pytest.mark.parametrize("table", list(_TABLES))
@pytest.mark.parametrize("e", [0, 1, 3])
def test_extended_segments_brute_force(table, e):
    """Every centre column's block segment is its global segment clipped to
    the block, every column that its windows, cascade candidates and their
    windows reach inside its segment lies in that block segment, and the
    dummy segments hold exactly the wrapped columns."""
    segments = _TABLES[table]
    n_global = segments[-1][1]
    r, g = 5, 7
    h = r + g + 2 * e
    for sp in (1, 2, 4):
        local = n_global // sp
        for shard in range(sp):
            col0 = shard * local
            blk = extended_segments(n_global, segments, col0, local, h)
            edges = [0] + [b for _, b in blk]
            assert [a for a, _ in blk] == edges[:-1] and edges[-1] == local + 2 * h
            glob = [(a + col0 - h, b + col0 - h) for a, b in blk]
            for a, b in glob:
                wrapped = b <= 0 or a >= n_global
                assert wrapped or (0 <= a and b <= n_global)
            for c in range(col0, col0 + local):
                sa, sb = next(s for s in segments if s[0] <= c < s[1])
                ba, bb = next(s for s in glob if s[0] <= c < s[1])
                assert (ba, bb) == (max(sa, col0 - h), min(sb, col0 + local + h))
                for x in range(c - 2 * e - r - g, c + 2 * e + r + g + 1):
                    if sa <= x < sb:
                        assert ba <= x < bb, (sp, shard, c, x)


def _halo_blocks(rdm, sp, h):
    """Each shard's halo-extended block as ``sharded_cascaded_cfar2d`` has
    ``halo_exchange`` deliver it: the ring wraps at the global edges, and
    the right halo is wider by the columns that make a row whole 16 bytes."""
    n = rdm.shape[-1]
    local = n // sp
    w = local + 2 * h + -(local + 2 * h) % 4
    ext = torch.cat([rdm[..., -h:], rdm, rdm[..., : w - local - h]], dim=-1)
    return [(s * local, ext[..., s * local : s * local + w]) for s in range(sp)]


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("e", [0, 1, 3])
def test_b1_route_plain_stand_in_matches_whole(sp, e):
    """The kernel route of the sharded CFAR, run by B1's plain version on the
    CPU: ``segmented_cfar`` over each extended block's table, centres
    stitched, equals ``segmented_cfar`` over the whole RDM at shards that cut
    segments, with the re-notch band's self-flagging rows (C8)."""
    rng = np.random.default_rng(100 + 10 * sp + e)
    segments = W.SEG3["cfar_segments"]
    rdm = (np.abs(rng.standard_normal((2, 64, 344))) + 0.5).astype(np.float32)
    rdm[:, 29:36] = 0.0
    for _ in range(60):
        rdm[rng.integers(0, 2), rng.integers(5, 59), rng.integers(0, 344)] += 40.0
    rdm[:, 20, [0, 23, 24, 85, 86, 103, 104, 171, 172, 257, 258, 343]] += 40.0
    cfg = dataclasses.replace(W.CFG_T5, range_extend_cells=e)
    x = torch.from_numpy(rdm)
    want_f, want_v = tcfar.segmented_cfar(x, segments, cfg, 4)
    h = cfg.ref_cells + cfg.guard_cells + 2 * e
    parts = [tsharding.extended_block_cfar(blk, cfg, 4, 344, segments, c0, 344 // sp, h)
             for c0, blk in _halo_blocks(x, sp, h)]
    np.testing.assert_array_equal(torch.cat([f for f, _ in parts], -1).numpy(), want_f.numpy())
    np.testing.assert_array_equal(torch.cat([v for _, v in parts], -1).numpy(), want_v.numpy())
    assert want_f.any()


def test_extended_segments_rejects_bad_tables():
    with pytest.raises(ValueError, match="tile"):
        extended_segments(344, ((0, 24), (30, 344)), 0, 344, 14)
    with pytest.raises(ValueError, match="outside"):
        extended_segments(344, ((0, 344),), 0, 10, 14)


# ---------------------------------------------------------------- world 1
@pytest.fixture
def world1():
    """A world-1 gloo group formed without torchrun's environment."""
    import torch.distributed as dist

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        assert key not in os.environ
    assert tmultihost.initialize_distributed("cpu") == (0, 1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_of_wrong_size_raises(world1):
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_mesh(("dp", "sp"), (2, 2), "cpu")
    mesh = tmesh.make_mesh(("dp", "sp"), None, "cpu")
    assert (tmesh.axis_size(mesh, "dp"), tmesh.axis_size(mesh, "sp")) == (1, 1)


@pytest.mark.parametrize("segments", [(), W.SEGMENTS_160], ids=["whole", "segmented"])
def test_world1_sharded_cascade_runs_b1_on_the_block(world1, segments):
    """With one rank on sp no column lies outside the block: the sharded
    cascade is B1 on it as it is, equal to ``segmented_cfar`` and to the
    JAX sharded cascade on one device, bit for bit."""
    rdm = W.rdm_input(W.rng_of(f"world1{len(segments)}"))
    mesh = tmesh.make_mesh(("dp", "sp"), (1, 1), "cpu")
    tf, tv = tsharding.sharded_cascaded_cfar2d(torch.from_numpy(rdm), W.CFG_57, 6, mesh, "sp",
                                               160, segments)
    wf, wv = tcfar.segmented_cfar(torch.from_numpy(rdm), segments or ((0, 160),), W.CFG_57, 6)
    jf, jv = _jshard(
        lambda x: jsharding.sharded_cascaded_cfar2d(x, _jcfg(W.CFG_57), 6, "sp", 160, segments),
        _jmesh(("dp", "sp"), (1, 1)), P(None, "sp"), (P(None, "sp"), P(None, "sp")))(
        jnp.asarray(rdm))
    assert tf.any()
    for got, want, jax_want in ((tf, wf, jf), (tv, wv, jv)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_want))


def test_mesh_stream_warns_below_parity_floor(world1, caplog):
    """A toy geometry below the CFAR parity floor (cropped velocity extent
    <= 2*(ref+guard)) warns; a real one does not."""
    import logging

    from radar_signal_process_tpu_torch.models.streaming import StreamingPipeline

    mesh = tmesh.make_mesh(("dp", "sp"), (1, 1), "cpu")
    small = dataclasses.replace(W.TINY344, prt_per_frame=16, point_prt=128,
                                segment_points=(24, 40, 64), cfar_segments=())
    with caplog.at_level(logging.WARNING, logger="radar_tpu_torch.streaming"):
        StreamingPipeline(None, small, win_size=2, mesh=mesh, clutter_v=3.0, device="cpu")
    assert any("parity floor" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="radar_tpu_torch.streaming"):
        StreamingPipeline(None, tconfig.G2_PROFILE, win_size=2, mesh=mesh, device="cpu")
    assert not any("parity floor" in r.message for r in caplog.records)


def _cli_rows(text):
    return json.loads(text.strip().splitlines()[-1])


def _assert_same_rows(got, want):
    """Detection rows ``[beam, win, v, r, amp]``: cells equal, amplitudes to
    the f32 tolerance."""
    assert [g["frame"] for g in got] == [w["frame"] for w in want]
    for g, w in zip(got, want):
        gs, ws = sorted(g["detections"]), sorted(w["detections"])
        assert [r[:4] for r in gs] == [r[:4] for r in ws]
        np.testing.assert_allclose([r[4] for r in gs], [r[4] for r in ws], rtol=1e-4)


def test_cli_e2e_mesh_matches_jax_and_unsharded(runs, capsys, monkeypatch):
    """``e2e --mesh 2x2`` under torchrun (4 gloo ranks): rank 0 prints the
    JAX CLI's ``--mesh 2x2`` rows and the port's unsharded rows of slice 1;
    the other ranks print nothing."""
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    outs = runs.cli("e2e", 4)
    assert all(not o.strip() for o in outs[1:])
    got = _cli_rows(outs[0])["frames"]
    cap = str(runs.root / "cap_e2e")
    monkeypatch.setitem(jconfig.PROFILES, "TINYM", _j(W.CLI_PROFILE))
    assert jcli.main(E2E_ARGS + ["--input", cap, "--mesh", "2x2"]) == 0
    want = _cli_rows(capsys.readouterr().out)["frames"]
    assert any(f["detections"] for f in want)
    _assert_same_rows(got, want)
    assert tcli.main(E2E_ARGS + ["--input", cap, "--device", "cpu"]) == 0
    plain = _cli_rows(capsys.readouterr().out)["frames"]
    _assert_same_rows(got, [{"frame": f["frame"],
                             "detections": [r for r in f["detections"] if r[1] == 1]}
                            for f in plain])


def test_cli_e2e_mesh_1x1_in_process_equals_e2e(runs, capsys):
    """``e2e --mesh 1x1`` in a plain process (a world-1 group it forms and
    leaves) prints ``e2e``'s rows of that slice, bit for bit."""
    import torch.distributed as dist

    from radar_signal_process_tpu_torch import cli as tcli

    cap = str(runs.root / "cap_e2e")
    assert tcli.main(E2E_ARGS + ["--input", cap, "--device", "cpu", "--mesh", "1x1"]) == 0
    assert not dist.is_initialized()
    got = _cli_rows(capsys.readouterr().out)["frames"]
    assert tcli.main(E2E_ARGS + ["--input", cap, "--device", "cpu"]) == 0
    plain = _cli_rows(capsys.readouterr().out)["frames"]
    assert got == [{"frame": f["frame"], "detections": [r for r in f["detections"] if r[1] == 1]}
                   for f in plain]
    assert any(f["detections"] for f in got)
    with pytest.raises(ValueError, match="does not cover"):
        tcli.main(E2E_ARGS + ["--input", cap, "--device", "cpu", "--mesh", "2x2"])
    assert not dist.is_initialized()


def test_cli_mesh_keeps_the_callers_group(runs, world1, capsys):
    """``e2e --mesh 1x1`` inside a group its caller formed runs on that
    group and leaves it up."""
    import torch.distributed as dist

    from radar_signal_process_tpu_torch import cli as tcli

    cap = str(runs.root / "cap_e2e")
    assert tcli.main(E2E_ARGS + ["--input", cap, "--device", "cpu", "--mesh", "1x1"]) == 0
    assert dist.is_initialized() and dist.get_world_size() == 1
    got = _cli_rows(capsys.readouterr().out)["frames"]
    assert any(f["detections"] for f in got)


def test_cli_stream_mesh_matches_jax_and_unsharded(runs, capsys, monkeypatch):
    """``stream --mesh 1x2`` under torchrun (2 gloo ranks): per-window CFAR
    hits and detections per beam equal the JAX CLI's ``--mesh 1x2`` and the
    port's unsharded stream."""
    from radar_signal_process_tpu import cli as jcli
    from radar_signal_process_tpu_torch import cli as tcli

    outs = runs.cli("stream", 2)
    assert not outs[1].strip()
    got = _cli_rows(outs[0])
    cap = str(runs.root / "cap_stream")
    monkeypatch.setitem(jconfig.PROFILES, "TINYS", _j(W.CLI_PROFILE))
    assert jcli.main(STREAM_ARGS + ["--input", cap, "--mesh", "1x2"]) == 0
    want = _cli_rows(capsys.readouterr().out)
    assert tcli.main(STREAM_ARGS + ["--input", cap, "--device", "cpu"]) == 0
    plain = _cli_rows(capsys.readouterr().out)
    assert [f["frame"] for f in got["frames"]] == [0, 1, 2]
    for g, w, p in zip(got["frames"], want["frames"], plain["frames"]):
        for key in ("frame", "cfar_hits", "detections_per_beam"):
            assert g[key] == w[key] == p[key], key
        assert g["cfar_hits"] > 0
    for key in ("frames_ingested", "windows_processed", "cfar_hits"):
        assert got["counters"][key] == want["counters"][key] == plain["counters"][key]

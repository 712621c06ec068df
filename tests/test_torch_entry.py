"""The port's entry points (``radar_signal_process_tpu_torch/entry.py``) and
meshes over part of the world, against the JAX package.

The port's side runs in gloo groups of 8, 4, 3 and 2 processes
(``tests/torch_entry_worker.py``: torch, numpy and the port only), all
started together once per module, each with a timeout, so a hang fails a
test; the world-1 dry run runs in this process.  The JAX side is computed
here on the CPU, from the same ``default_rng(0)`` draws in the order of the
JAX ``__graft_entry__.py`` (copied below as the reference, independent of
the port's drawing).

* **Sub-meshes.** Rings over ranks [0, 1], [2, 3] and [0, 1, 2] of a world
  of 4 give, bit for bit, the ring of a world of exactly their size; a
  (1, 2) dp x sp pipeline over ranks [2, 3] lands on rank 2 and equals
  the one over a whole world of 2; ranks outside a mesh get ``None``.
* **The dry run** at worlds 8, 4 and 1: every leg's RDM within ``RTOL`` and
  ``PEAK_ATOL`` of the peak (the tolerances of ``test_torch_parallel.py``)
  of the JAX package's unsharded chain on the same inputs, the chain the
  JAX dry run holds its sharded legs to; flags equal to the JAX CFAR rerun
  on the port's RDM (ROADMAP C5); the printed line equal to the JAX
  function's at that n, the RDM hashes aside.
* **The forward step** at a TINY G2 profile against the JAX forward step
  composed from the same three functions, and ``entry``'s example equal to
  the JAX ``entry()``'s.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from radar_signal_process_tpu import config as jconfig
from radar_signal_process_tpu.models.detect import clutter_cells as jclutter_cells
from radar_signal_process_tpu.models.detect import detect_rdm as jdetect_rdm
from radar_signal_process_tpu.models.mtd_pipeline import mtd_produce as jmtd_produce
from radar_signal_process_tpu.models.mtd_pipeline import slice_cpi_window as jslice
from radar_signal_process_tpu.ops import cfar as jcfar
from radar_signal_process_tpu.ops.pulse_compression import segmented_pulse_compression as jpc
from radar_signal_process_tpu.ops.waveforms import reference_pulses as jpulses
from radar_signal_process_tpu_torch import config as tconfig
from radar_signal_process_tpu_torch import entry
from radar_signal_process_tpu_torch.parallel import mesh as tmesh
from radar_signal_process_tpu_torch.parallel import multihost as tmultihost
from tests.test_torch_import import as_config

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_entry_worker.py"
RTOL, PEAK_ATOL = 2e-4, 2e-5
WORLDS = {"w8": 8, "w4": 4, "w3": 3, "w2": 2}
TIMEOUT_S = 300
# the JAX dry run's line at each n; n = 8 is the record MULTICHIP_r05.json,
# n = 1 and 4 were printed by __graft_entry__.dryrun_multichip(n) on an
# n-device CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=n)
JAX_LINES = {
    1: "dryrun_multichip: mesh (dp=1, sp=1) renotch=20 ok; rdm (2, 8, 3404), cascade hits 0 "
       "(== unsharded, edge columns clean); stream 2 windows ok (hits 0, 0; "
       "carry==recompress); mesh StreamingPipeline 4 windows in order",
    4: "dryrun_multichip: mesh (dp=2, sp=2) renotch=20 ok; rdm (4, 16, 3404), cascade hits 0 "
       "(== unsharded, edge columns clean); stream 2 windows ok (hits 0, 0; "
       "carry==recompress); mesh StreamingPipeline 4 windows in order; pp=2 stage ring ok, "
       "hits 2, hash f8394cc1fc8b; pp=3 stage ring ok, hits 2, hash f8394cc1fc8b; pp=4 stage "
       "ring ok, hits 2, hash f8394cc1fc8b; g0-pp depth 4 (fft 48->64 unshifted) ok, hits 0; "
       "ep=4 MoE routing ok",
}
LEGS = {1: ("pipeline", "stream", "streaming"),
        4: ("pipeline", "stream", "streaming", "pp2", "pp3", "pp4", "g0pp", "ep"),
        8: ("pipeline", "stream", "streaming", "e2e", "pp2", "pp3", "pp4", "g0pp", "ep")}


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


class Runs:
    """The module's process groups, started together with the module's first
    test and awaited on first use; the world-1 dry run in this process on
    first use."""

    def __init__(self, root: pathlib.Path):
        self.root = root
        self.procs = {}
        self.done = {}
        self.world1 = None
        for name, world in WORLDS.items():
            d = root / name
            d.mkdir()
            self.procs[name] = [subprocess.Popen(
                [sys.executable, str(WORKER), name, str(r), str(world), str(d / "init"), str(d)],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for r in range(world)]

    def wait(self, name: str):
        if name not in self.done:
            logs = []
            for p in self.procs[name]:
                try:
                    out, _ = p.communicate(timeout=TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.close()
                    raise
                logs.append(out)
            failed = [log for p, log in zip(self.procs[name], logs) if p.returncode != 0]
            self.done[name] = "\n".join(failed)[-6000:]
        assert not self.done[name], f"{name} ranks failed:\n{self.done[name]}"

    def case(self, group: str, case: str, rank: int) -> dict:
        self.wait(group)
        with np.load(self.root / group / f"{case}.{rank}.npz") as z:
            return {k: z[k] for k in z.files}

    def dryrun(self, n: int):
        """(rank 0's legs, every rank's standard output) of the dry run at n."""
        if n == 1:
            if self.world1 is None:
                import contextlib
                import io

                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), torch.inference_mode():
                    legs = entry.dryrun_multichip(1, "cpu")
                self.world1 = ({k: v.numpy() for k, v in legs.items()}, [buf.getvalue()])
            return self.world1
        group = f"w{n}"
        self.wait(group)
        with np.load(self.root / group / "dryrun.npz") as z:
            legs = {k: z[k] for k in z.files}
        return legs, [(self.root / group / f"dryrun.{r}.txt").read_text() for r in range(n)]

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("torch_entry"))
    yield r
    r.close()


def _assert_close(got, want):
    """f32 agreement relative to the peak (``test_torch_parallel.py``)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL, atol=PEAK_ATOL)


def _j(obj):
    return as_config(obj, jconfig)


# the JAX chain, jitted: op by op its first calls compile for ~10 s a leg
_jmtd = jax.jit(jmtd_produce, static_argnums=1)
_jdetect = jax.jit(jdetect_rdm, static_argnums=(1, 2), static_argnames=("cfg", "renotch_divisor"))
_jsegcfar = jax.jit(jcfar.segmented_cfar, static_argnums=(1, 2, 3))


# ----------------------------------------------------------- forward step
JTINY = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=64, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)), n_beams=3)


def test_g2_step_matches_the_jax_forward_step():
    """``G2Step`` at a TINY G2 profile against ``slice_cpi_window`` ->
    ``mtd_produce`` -> ``detect_rdm`` of the JAX package (n_clutter 14,
    threshold 5): RDMs to the f32 tolerance, flags equal to the JAX cascade
    on the port's RDMs."""
    tiny = as_config(JTINY, tconfig)
    shape = (tiny.n_beams, 2 * tiny.prt_per_frame, tiny.point_prt)
    x = _gauss(np.random.default_rng(0), shape)
    step = entry.G2Step(tiny, entry.CFARConfig(threshold=5.0), entry.N_CLUTTER)
    rdms, flags = step(torch.from_numpy(x))
    assert rdms.shape == flags.shape == (3, 4, 64, 344) and flags.dtype == torch.float32
    cfg = jconfig.CFARConfig(threshold=5.0)
    want = _jmtd(jslice(jnp.asarray(x), 4), JTINY)
    _assert_close(rdms.numpy(), want)
    jflags, _ = _jdetect(jnp.asarray(rdms.numpy()), JTINY, entry.N_CLUTTER, cfg=cfg)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags, dtype=np.float32))
    own, _ = _jdetect(want, JTINY, entry.N_CLUTTER, cfg=cfg)
    assert int(flags.sum()) == int(np.asarray(own).sum()) > 0


def test_entry_example_equals_the_jax_example():
    forward, (example,) = entry.entry(device="cpu")
    assert isinstance(forward, entry.G2Step) and forward.n_clutter == 14
    assert forward.cfg.threshold == 5.0 and forward.profile == entry.G2_PROFILE
    assert example.shape == (13, 664, 3404) and example.dtype == torch.complex64
    _, (want,) = jentry.entry()
    np.testing.assert_array_equal(example.numpy(), np.asarray(want))


# ---------------------------------------------------------------- dry run
def _gauss(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _jax_inputs(n: int) -> dict:
    """The JAX dry run's inputs at n, drawn as ``__graft_entry__.py`` draws
    them (the reference for the port's drawing)."""
    dp, sp = tmesh.best_mesh_shape(n, 2)
    n_beams, n_prt, n_pts = dp * 2, sp * 8, 3404
    if n_pts % sp:
        n_pts = sp * (n_pts // sp)
    rng = np.random.default_rng(0)
    shape = (n_beams, n_prt, n_pts)
    out = {"shape": shape, "echo": _gauss(rng, shape)}
    out["frames"] = [_gauss(rng, shape) for _ in range(3)]
    out["cubes"] = [np.moveaxis(_gauss(rng, shape), 0, -1) for _ in range(5)]
    if n % 8 == 0:
        tp3 = n // 4
        out["coeffs"] = _gauss(rng, (2 * tp3, 2 * tp3))
        out["iq"] = _gauss(rng, (2, 16, n_pts, 2 * tp3))
    if n >= 2:
        out["echo_pp"] = _gauss(rng, (4, 32, 344))
        if n >= 4:
            out["echo_g0"] = _gauss(rng, (5, 48, 160))
        n_ep = min(4, n)
        out["cal"] = (0.5 + rng.random((2 * n_ep, 344))).astype(np.float32)
        out["frames_ep"] = _gauss(rng, (4 * n_ep, 16, 344))
        out["bids"] = np.arange(4 * n_ep) % (2 * n_ep)
    return out


# the JAX dry run's stage-ring and padded-G0 profiles (__graft_entry__.py,
# prof_pp and prof_g0pp), built here apart from the port's copies
JPP = dataclasses.replace(
    jconfig.G2_PROFILE, prt_per_frame=16, point_prt=344, segment_points=(24, 80, 240),
    cfar_segments=((0, 24), (24, 104), (104, 344)))
JG0PP = dataclasses.replace(
    jconfig.G0_PROFILE, prt_per_frame=48, point_prt=160, segment_points=(32, 128),
    mtd=jconfig.MTDConfig(window="hamming", notch_divisor=0, fft_length=64, fftshift=False))


def test_dryrun_ring_profiles_equal_the_jax_dry_run_profiles():
    assert _j(entry.PP_PROFILE) == JPP
    assert _j(entry.G0_PP_PROFILE) == JG0PP


def _window(a, b):
    return jslice(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], axis=-2), 4)


def _check_flags(flags, want):
    np.testing.assert_array_equal(flags, np.asarray(want))


def _check_leg(n: int, leg: str, got: dict):
    """One leg of the port's dry run at n against the JAX package's
    unsharded chain on the same inputs."""
    x = _jax_inputs(n)
    prof = jconfig.G2_PROFILE
    cfg = jconfig.CFARConfig(threshold=5.0)
    if leg == "pipeline":
        _assert_close(got["pipeline_rdm"], _jmtd(jnp.asarray(x["echo"]), prof))
        flags, _ = _jdetect(jnp.asarray(got["pipeline_rdm"]), prof, 2, cfg=cfg,
                               renotch_divisor=20)
        _check_flags(got["pipeline_flags"], flags)
    elif leg == "stream":
        f = x["frames"]
        for key, (a, b) in (("0", (f[0], f[1])), ("1", (f[1], f[2])), ("1_fresh", (f[1], f[2]))):
            rdm = got[f"stream_rdm{key}"]
            assert rdm.shape == (x["shape"][0], 4) + x["shape"][1:]
            _assert_close(rdm, _jmtd(_window(a, b), prof))
            if key != "1_fresh":
                flags, _ = _jdetect(jnp.asarray(rdm), prof, 2, cfg=cfg, renotch_divisor=20)
                _check_flags(got[f"stream_flags{key}"], flags)
    elif leg == "streaming":
        frames = [np.moveaxis(c, -1, 0) for c in x["cubes"]]
        stream_prof = dataclasses.replace(prof, prt_per_frame=x["shape"][1],
                                          n_beams=x["shape"][0])
        n_clutter = jclutter_cells(stream_prof, x["shape"][1], 1e-6)
        for w in range(4):
            rdm = got[f"streaming_rdm{w}"]
            _assert_close(rdm, _jmtd(_window(frames[w], frames[w + 1]), stream_prof))
            flags, _ = _jdetect(jnp.asarray(rdm), stream_prof, n_clutter, renotch_divisor=20)
            _check_flags(got[f"streaming_flags{w}"], flags)
    elif leg == "e2e":
        echo = jnp.einsum("fpsc,bc->fbps", jnp.asarray(x["iq"]), jnp.asarray(x["coeffs"]))
        _assert_close(got["e2e_rdm"], _jmtd(echo, prof))
        flags, _ = _jsegcfar(jnp.asarray(got["e2e_rdm"]), prof.cfar_segments, cfg, 2)
        _check_flags(got["e2e_flags"], flags)
    elif leg in ("pp2", "pp3", "pp4", "g0pp"):
        pp_prof = JG0PP if leg == "g0pp" else JPP
        echo, segments, n_clutter = ((x["echo_g0"], ((0, 160),), 3) if leg == "g0pp" else
                                     (x["echo_pp"], pp_prof.cfar_segments, 4))
        _assert_close(got[f"{leg}_rdm"], _jmtd(jnp.asarray(echo), pp_prof))
        flags, _ = _jsegcfar(jnp.asarray(got[f"{leg}_rdm"]), segments, cfg, n_clutter)
        _check_flags(got[f"{leg}_flags"], flags)
    elif leg == "ep":
        pp_prof = JPP
        calibrated = x["frames_ep"] * x["cal"][x["bids"]][:, None, :]
        _assert_close(got["ep_out"], jpc(jnp.asarray(calibrated), pp_prof, jpulses(pp_prof)))
    else:
        raise AssertionError(leg)


@pytest.mark.parametrize("n,leg", [(n, leg) for n in (1, 4, 8) for leg in LEGS[n]])
def test_dryrun_leg_matches_jax(runs, n, leg):
    """Each leg the JAX dry run runs at n returned its outputs, held to the
    JAX package's chain on the same draws."""
    legs, _ = runs.dryrun(n)
    _check_leg(n, leg, legs)


def _mask_hashes(line: str) -> str:
    return re.sub(r"hash [0-9a-f]{12}", "hash <sha256>", line.strip())


def _jax_line(n: int) -> str:
    if n == 8:
        tail = json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]
        return tail.strip().splitlines()[-1]
    return JAX_LINES[n]


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_line_matches_jax(runs, n):
    """Rank 0 prints the JAX line, legs and counts alike, hashes aside (its
    RDM bits are torch's), after a line saying whether the carried and the
    recompressed stream RDMs are bit-identical; the other ranks print
    nothing."""
    _, outs = runs.dryrun(n)
    lines = outs[0].strip().splitlines()
    assert _mask_hashes(lines[-1]) == _mask_hashes(_jax_line(n))
    assert any(re.fullmatch(r"dryrun_multichip: stream: carried PC against recompressed, "
                            r"RDMs (bit-identical|within 1e-3)", s) for s in lines[:-1])
    assert all(not o.strip() for o in outs[1:])


def test_dryrun_draws_the_jax_inputs():
    """The reference drawing above is the JAX dry run's own: its first draw
    at n = 1 is ``__graft_entry__``'s echo (complex128 cast to complex64)."""
    rng = np.random.default_rng(0)
    echo = rng.standard_normal((2, 8, 3404)) + 1j * rng.standard_normal((2, 8, 3404))
    np.testing.assert_array_equal(_jax_inputs(1)["echo"], echo.astype(np.complex64))


def test_dryrun_needs_its_world_size():
    with pytest.raises(ValueError, match="process group of 1"):
        entry.dryrun_multichip(2, "cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_make_mesh_checks_its_ranks():
    """Ranks that repeat, lie outside the world or do not fill the shape
    raise; a world-covering mesh keeps the world's group for the gather."""
    import torch.distributed as dist

    assert tmultihost.initialize_distributed("cpu") == (0, 1)
    try:
        for ranks, shape in (([0, 0], (2,)), ([1], (1,)), ([0], (2,))):
            with pytest.raises(ValueError):
                tmesh.make_mesh(("pp",), shape, "cpu", ranks=ranks)
        mesh = tmesh.make_mesh(("pp",), (1,), "cpu", ranks=[0])
        assert mesh.mesh.tolist() == [0] and mesh.whole_group is dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_gather_blocks_names_a_mesh_it_cannot_gather_over():
    """A ``DeviceMesh`` built without ``make_mesh`` has no group over its
    ranks: the gather says so instead of failing on a missing attribute."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks

    tmultihost.initialize_distributed("cpu")
    try:
        mesh = DeviceMesh("cpu", torch.tensor([0]), mesh_dim_names=("pp",))
        with pytest.raises(TypeError, match="make_mesh"):
            gather_blocks(torch.zeros(2), mesh, ("pp",))
        built = tmesh.make_mesh(("pp",), (1,), "cpu")
        assert torch.equal(gather_blocks(torch.ones(2), built, ("pp",)), torch.ones(2))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- sub-meshes
@pytest.mark.parametrize("case,whole,ranks", [("pp2_01", ("w2", "pp2"), (0, 1)),
                                              ("pp2_23", ("w2", "pp2"), (2, 3)),
                                              ("pp3_012", ("w3", "pp3"), (0, 1, 2))])
def test_ring_on_a_sub_mesh_equals_the_ring_of_its_own_world(runs, case, whole, ranks):
    """Every member gets the last stage's outputs, equal bit for bit to the
    same ring over a whole world of its size; the other ranks get no mesh."""
    want = runs.case(*whole, 0)
    assert want["flags"].any()
    for rank in range(4):
        got = runs.case("w4", case, rank)
        assert bool(got["member"]) == (rank in ranks)
        if rank in ranks:
            for k in ("rdm", "flags"):
                np.testing.assert_array_equal(got[k], want[k])
        else:
            assert set(got) == {"member"}


def test_pipeline_on_a_sub_mesh_lands_on_its_first_rank(runs):
    """A (1, 2) pipeline over ranks [2, 3] is gathered on rank 2 (the JAX
    ``devices=`` sub-mesh; the gather no longer goes to global rank 0) and
    equals the same pipeline over a whole world of 2."""
    want = runs.case("w2", "pipe", 0)
    assert bool(want["gathered"]) and not bool(runs.case("w2", "pipe", 1)["gathered"])
    got = {r: runs.case("w4", "pipe_23", r) for r in range(4)}
    assert [bool(got[r]["member"]) for r in range(4)] == [False, False, True, True]
    assert bool(got[2]["gathered"]) and not bool(got[3]["gathered"])
    for k in ("rdm", "flags"):
        np.testing.assert_array_equal(got[2][k], want[k])
    assert want["flags"].any()


def test_dryrun_raises_without_a_card():
    """Its default device is the card: without one it raises, and forms no
    gloo group in its place (``entry()`` is in ``test_torch_import.py``)."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default would run there")
    with pytest.raises(RuntimeError, match="is_available"):
        entry.dryrun_multichip(1)
    assert not dist.is_initialized()

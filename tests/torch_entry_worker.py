"""Rank body of ``tests/test_torch_entry.py``: one process of a gloo group
that runs meshes over part of the world and the port's multi-device dry run.

Imports torch, numpy and the port only (the parent test computes the JAX
side), and the seeded inputs of ``tests/torch_parallel_worker.py``::

    python tests/torch_entry_worker.py NAME RANK WORLD INIT_FILE OUT_DIR

joins a gloo group through ``INIT_FILE`` and runs group ``NAME``: its
meshes (each rank writes ``OUT_DIR/<case>.<rank>.npz``: whether it is a
member, and what it holds), then, where the group has one, the dry run at
the world size (rank 0 writes its legs to ``OUT_DIR/dryrun.npz``; every
rank its standard output to ``OUT_DIR/dryrun.<rank>.txt``).
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from radar_signal_process_tpu_torch import entry
from radar_signal_process_tpu_torch.parallel import make_mesh, make_sharded_pipeline
from radar_signal_process_tpu_torch.parallel.sharding import gather_blocks, local_block
# a sibling on the script's own path: a ``tests`` package installed elsewhere
# may shadow this directory's
import torch_parallel_worker as W  # noqa: E402

PP_SHAPE = (5, 64, 344)
PIPE_SHAPE = (2, 32, 344)


def pp_echo() -> torch.Tensor:
    return torch.from_numpy(W.cplx(W.rng_of("pp-sub"), PP_SHAPE))


def pipe_echo() -> torch.Tensor:
    return torch.from_numpy(W.cplx(W.rng_of("pipe-sub"), PIPE_SHAPE))


def case_pp(mesh) -> dict:
    from radar_signal_process_tpu_torch.parallel import make_pipeline_parallel

    rdm, flags = make_pipeline_parallel(W.TINY344, mesh, W.CFG_T5, n_clutter=4)(pp_echo())
    return {"rdm": rdm.numpy(), "flags": flags.numpy()}


def case_pipeline(mesh) -> dict:
    """The (dp, sp) pipeline with the re-notch; the blocks gathered on the
    mesh's first rank, ``None`` on the others."""
    run = make_sharded_pipeline(W.TINY344, mesh, W.CFG_T5, 4, renotch_divisor=20)
    rdm, flags, _ = run(local_block(pipe_echo(), mesh, ("dp", "sp", None)).contiguous())
    spec = ("dp", None, "sp")
    rdm, flags = gather_blocks(rdm, mesh, spec), gather_blocks(flags, mesh, spec)
    if rdm is None:
        return {"gathered": np.asarray(False)}
    return {"gathered": np.asarray(True), "rdm": rdm.numpy(), "flags": flags.numpy()}


# group -> ([(case, mesh axes, mesh shape, ranks or None for the world, fn)],
#           whether the group runs the dry run at its world size)
GROUPS = {
    "w8": ([], True),
    "w4": ([("pp2_01", ("pp",), (2,), [0, 1], case_pp),
            ("pp2_23", ("pp",), (2,), [2, 3], case_pp),
            ("pp3_012", ("pp",), (3,), [0, 1, 2], case_pp),
            ("pipe_23", ("dp", "sp"), (1, 2), [2, 3], case_pipeline)], True),
    "w3": ([("pp3", ("pp",), (3,), None, case_pp)], False),
    "w2": ([("pp2", ("pp",), (2,), None, case_pp),
            ("pipe", ("dp", "sp"), (1, 2), None, case_pipeline)], False),
}


def run_group(name: str, rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    cases, dryrun = GROUPS[name]
    try:
        for case, axes, shape, ranks, fn in cases:
            mesh = make_mesh(axes, shape, "cpu", ranks=ranks)
            out = {"member": np.asarray(mesh is not None)}
            if mesh is not None:
                with torch.inference_mode():
                    out.update(fn(mesh))
            np.savez(os.path.join(out_dir, f"{case}.{rank}.npz"), **out)
            dist.barrier()
        if dryrun:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                legs = entry.dryrun_multichip(world, "cpu")
            with open(os.path.join(out_dir, f"dryrun.{rank}.txt"), "w") as fh:
                fh.write(buf.getvalue())
            if rank == 0:
                np.savez(os.path.join(out_dir, "dryrun.npz"),
                         **{k: v.numpy() for k, v in legs.items()})
            else:
                assert legs is None
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run_group(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

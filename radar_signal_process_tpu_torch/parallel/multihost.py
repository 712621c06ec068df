"""Process-group set-up and host-side frame assignment.

Counterpart of ``radar_signal_process_tpu/parallel/multihost.py``.  Where
the JAX package runs one process per host over ``jax.distributed``, the port
runs one process per rank: ``torchrun`` (``python -m
torch.distributed.run``) starts them and sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT`` and ``LOCAL_RANK``.  NCCL carries the
collectives on the card and needs one GPU per rank; gloo carries them on the
CPU.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from radar_signal_process_tpu_torch.device import resolve_device


def initialize_distributed(device_type: str = "cuda") -> Tuple[int, int]:
    """Join (or start) the default process group; returns ``(rank, world)``.

    The backend follows the device: NCCL for ``cuda``, on the card
    ``LOCAL_RANK``; gloo for ``cpu``.  Under ``torchrun`` the group forms
    from its environment; without it this process forms a group of one
    from an in-process store, as the JAX package runs single-process when no
    coordinator is set.  A group that already exists is joined as it is.
    ``cuda`` without a card, or with fewer cards than local ranks, raises;
    TF32 is switched off on every rank.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device_type)
    backend = "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local} has no card of its own: {torch.cuda.device_count()} "
                "visible (NCCL takes one GPU per rank)")
        torch.cuda.set_device(local)
        backend = "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()


def host_frame_assignment(
    n_frames: int, process_id: int | None = None, num_processes: int | None = None
) -> Sequence[int]:
    """Contiguous frame ranges per process for data-parallel ingest.

    Frame pairs need one-frame overlap at the boundary (the doubled-CPI
    window pairs frame i with i+1), so each range extends one frame past its
    last owned frame.  The defaults are this process's rank and the world
    size (0 and 1 without a process group).
    """
    grouped = dist.is_initialized()
    pid = (dist.get_rank() if grouped else 0) if process_id is None else process_id
    n = (dist.get_world_size() if grouped else 1) if num_processes is None else num_processes
    per = -(-n_frames // n)
    start = pid * per
    stop = min(n_frames, start + per)
    if stop < n_frames:
        stop += 1  # CPI-pair overlap
    return range(start, stop)

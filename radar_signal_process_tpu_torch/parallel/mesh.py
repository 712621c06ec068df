"""Device meshes over ``torch.distributed``.

Counterpart of ``radar_signal_process_tpu/parallel/mesh.py``: a JAX
``Mesh(("dp", "sp"))`` becomes a ``DeviceMesh`` with the same axis names,
one process per rank.  ``axis_size`` and ``axis_index`` stand for
``lax.axis_size`` and ``lax.axis_index``; the collectives of an axis run on
``mesh.get_group(axis)``, and those of the whole mesh (the gather of
``parallel.sharding.gather_blocks``) on ``mesh.whole_group``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def best_mesh_shape(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` as near-square as possible.

    E.g. 8 -> (2, 4), 4 -> (2, 2), 1 -> (1, 1), 6 -> (2, 3).
    """
    if n_axes == 1:
        return (n_devices,)
    best = (1, n_devices)
    for a in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % a == 0:
            best = (a, n_devices // a)
    if n_axes == 2:
        return best
    return (1,) * (n_axes - 2) + best  # degenerate leading axes


def make_mesh(
    axis_names: Sequence[str] = ("dp", "sp"),
    shape: Sequence[int] | None = None,
    device_type: str = "cuda",
    ranks: Sequence[int] | None = None,
) -> Optional[DeviceMesh]:
    """A mesh over ``ranks`` of the initialised process group
    (:func:`parallel.multihost.initialize_distributed`); the counterpart of
    the JAX ``make_mesh(..., devices=)``.

    ``ranks`` lists global ranks in row-major mesh order (``None``: every
    rank, in order).  With ``shape=None`` their count is factored across
    the axes (data-parallel x sequence/range-parallel by default); a shape
    whose product is not that count raises.  Group creation is collective,
    so every rank of the world calls this, members or not; a rank outside
    ``ranks`` gets ``None`` and takes no part in the mesh's collectives.
    The mesh carries ``whole_group``, a process group over all its ranks.
    """
    world = dist.get_world_size()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(set(members)) != len(members) or not all(0 <= r < world for r in members):
        raise ValueError(f"mesh ranks {members} are not distinct ranks of a world of {world}")
    if shape is None:
        shape = best_mesh_shape(len(members), len(axis_names))
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != len(members):
        raise ValueError(
            f"mesh {dict(zip(axis_names, shape))} does not cover the {len(members)} rank(s) "
            f"{members} of the process group"
        )
    mesh = DeviceMesh(device_type, torch.tensor(members).view(shape),
                      mesh_dim_names=tuple(axis_names))
    whole = dist.group.WORLD if len(members) == world else dist.new_group(members)
    if dist.get_rank() not in members:
        return None
    mesh.whole_group = whole
    return mesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along ``axis`` (``lax.axis_size``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)

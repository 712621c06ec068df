"""Multi-device execution over ``torch.distributed``: meshes, range-sharded
CFAR with halo exchange, sharded chains, a pipeline-parallel stage ring and
expert-parallel beam calibration.

Counterpart of ``radar_signal_process_tpu/parallel/``, one process per rank
(``torchrun``; NCCL on the card, one GPU per rank; gloo on the CPU):

* ``mesh``      -- ``DeviceMesh`` construction helpers;
* ``multihost`` -- process-group set-up and host-side frame assignment;
* ``sharding``  -- the per-rank sharded chains and their collectives.
"""

from radar_signal_process_tpu_torch.parallel.mesh import make_mesh, best_mesh_shape  # noqa: F401
from radar_signal_process_tpu_torch.parallel.sharding import (  # noqa: F401
    halo_exchange,
    sharded_cfar1d_ref_level,
    make_sharded_pipeline,
    make_sharded_e2e,
    make_pipeline_parallel,
    make_expert_parallel,
)

"""Scale-out of the port: the (data, model) layout of the ranks, the
process group under ``torchrun`` and each rank's episode shard, and the
data-parallel step's reductions (port of ``litemkd_tpu/parallel``; the
``model`` axis is not ported yet)."""
from .mesh import Mesh, check_data_parallel, make_mesh
from .multihost import (DataParallel, host_rng, init_distributed,
                        local_episode_count, shard_batch, shutdown)

__all__ = ["Mesh", "check_data_parallel", "make_mesh", "DataParallel",
           "host_rng", "init_distributed", "local_episode_count",
           "shard_batch", "shutdown"]

"""Scale-out of the port: the (data, model) layout of the ranks and its
process groups under ``torchrun``, each replica's episode shard, the
data-parallel step's reductions and the tensor-parallel layers of the
``model`` axis (port of ``litemkd_tpu/parallel``)."""
from .mesh import Mesh, MeshGroups, make_mesh, param_spec
from .multihost import (DataParallel, host_rng, init_distributed,
                        local_episode_count, shard_batch, shutdown)
from .tensor_parallel import (ModelAxis, full_state_dict, shard_model,
                              sharded_parameters)

__all__ = ["Mesh", "MeshGroups", "make_mesh", "param_spec", "DataParallel",
           "host_rng", "init_distributed", "local_episode_count",
           "shard_batch", "shutdown", "ModelAxis", "full_state_dict",
           "shard_model", "sharded_parameters"]

"""The (data, model) layout of a run over several processes (port of
``litemkd_tpu/parallel/mesh.py``).

In the JAX package a mesh is a grid of devices with a ``data`` axis (the
episode batch is sharded over it) and a ``model`` axis (the wide
projections are sharded over it, ``param_spec``). In the port a device is
a process of its own under ``torchrun``, one rank per card, so the mesh is
the layout of the ranks: :func:`make_mesh` applies the JAX package's rules
and raises its errors on the world size, and the ranks lie in the grid as
JAX's ``np.asarray(devices).reshape(data, model)`` lays the devices out:
rank r sits at data index ``r // model`` and model index ``r % model``, so
a model group is ``model`` consecutive ranks (NVLink neighbours on one
node).

:func:`param_spec` is the JAX package's rule table in the port's terms:
which parameter of a module is sharded over ``model``, along which axis
(:mod:`litemkd_torch.parallel.tensor_parallel` applies it).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

from torch import nn

from ..config import MeshConfig


class MeshGroups(NamedTuple):
    """This rank's process groups: ``data`` holds the ranks of its model
    index (the replicas its gradients and BatchNorm moments are summed
    over), ``model`` the ranks of its data index (the shards of one
    replica)."""

    data: object
    model: object


class Mesh(NamedTuple):
    """``data`` × ``model`` ranks; ``shape`` names the axes as a JAX mesh
    does."""

    data: int
    model: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, model index) of global rank ``rank``."""
        return rank // self.model, rank % self.model

    def model_ranks(self, data_index: int):
        return list(range(data_index * self.model,
                          (data_index + 1) * self.model))

    def data_ranks(self, model_index: int):
        return list(range(model_index, self.size, self.model))

    def groups(self, rank: int) -> MeshGroups:
        """Create every data group and every model group of the mesh (each
        rank must call this, in the same order: ``dist.new_group`` is a
        collective over the world) and return rank ``rank``'s two."""
        import torch.distributed as dist
        d, m = self.coords(rank)
        model = [dist.new_group(self.model_ranks(i)) for i in range(self.data)]
        data = [dist.new_group(self.data_ranks(j)) for j in range(self.model)]
        return MeshGroups(data[m], model[d])


def make_mesh(cfg: Optional[MeshConfig], world: int) -> Mesh:
    """The layout of ``world`` ranks that ``cfg`` asks for, with the JAX
    package's rules: ``model`` is at least 1 and must divide the world;
    ``data`` -1 takes the rest; ``data × model`` must be the world."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    if world % model != 0:
        raise ValueError(f"{world} devices not divisible by model={model}")
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    return Mesh(data, model)


# kinds of sharding (the JAX package's PartitionSpecs on a Dense kernel of
# (in, out), in the terms of a torch weight of (out, in))
COLUMN = "column"   # P(None, "model"): the output features, torch dim 0
ROW = "row"         # P("model", None): the input features, torch dim 1


class ParamSpec(NamedTuple):
    """A sharded parameter: ``kind`` (:data:`COLUMN` or :data:`ROW`), the
    torch axis that is cut, and the number of stacked ``blocks`` along it
    that are each cut (3 for the q; k; v thirds of ``in_proj_weight``)."""

    kind: str
    dim: int
    blocks: int = 1


def param_spec(module: nn.Module, name: str) -> Optional[ParamSpec]:
    """The JAX rule (``litemkd_tpu/parallel/mesh.py:50-58``) that shards
    the weight of ``module``'s child or parameter ``name``, or None.

    JAX matches flax paths; the port matches the module that owns the
    layer, since several of the port's names are not JAX's (a lone
    backbone head ``fc``/``res18_2048`` is JAX's ``fc1``; DeiT's ``fc1``
    is JAX's ``mlp_in_{i}``, which no rule hits; ``f1`` is JAX's
    ``fuse_proj`` only in the stream fusions). Only weights are sharded,
    as in JAX (its rules end in ``/kernel``): biases, LayerNorms,
    convolutions and BatchNorm statistics stay replicated.

    - columns: ``k_linear``/``v_linear`` of a TCT; a backbone's ``fc1``,
      ``fc2`` or lone head; the squeeze-excite's ``fc1``/``fc2``; the q, k
      and v thirds of an encoder layer's ``in_proj_weight``; its
      ``linear1``; a stream fusion's ``f1``;
    - rows: an encoder layer's ``out_proj`` and ``linear2``."""
    from ..models.backbones.mobilenet import MobileNetV3Backbone, SqueezeExcite
    from ..models.backbones.resnet import ResNetBackbone
    from ..models.backbones.strm import STRMBackbone
    from ..models.teacher.fusion import (EncoderLayer, MultiStreamFusion,
                                         SelfAttention)
    from ..ops.tct import TemporalCrossTransformer
    col, row = ParamSpec(COLUMN, 0), ParamSpec(ROW, 1)
    if isinstance(module, TemporalCrossTransformer):
        return col if name in ("k_linear", "v_linear") else None
    if isinstance(module, (ResNetBackbone, MobileNetV3Backbone)):
        return col if name in module.fc_names else None
    if isinstance(module, STRMBackbone):
        return col if name in ("fc1", "fc2") and module.num_fc == 2 else None
    if isinstance(module, SqueezeExcite):
        return col if name in ("fc1", "fc2") else None
    if isinstance(module, SelfAttention):
        return {"in_proj_weight": ParamSpec(COLUMN, 0, 3),
                "out_proj": row}.get(name)
    if isinstance(module, EncoderLayer):
        return {"linear1": col, "linear2": row}.get(name)
    if isinstance(module, MultiStreamFusion):
        return col if name == "f1" else None
    return None


def divides(shape, spec: ParamSpec, model: int) -> bool:
    """JAX's fallback (``mesh.py:84-93``): a spec whose cut axis (each
    block of it) does not divide ``model`` leaves the parameter
    replicated."""
    return (shape[spec.dim] // spec.blocks) % model == 0

"""The (data, model) layout of a run over several processes (port of
``litemkd_tpu/parallel/mesh.py:23-36``).

In the JAX package a mesh is a grid of devices with a ``data`` axis (the
episode batch is sharded over it) and a ``model`` axis (the wide
projections are sharded over it, ``param_spec``). In the port a device is
a process of its own under ``torchrun``, one rank per card, so the mesh is
the layout of the ranks: :func:`make_mesh` applies the JAX package's rules
and raises its errors on the world size. The port runs the ``data`` axis
(:mod:`litemkd_torch.parallel.data_parallel`); a ``model`` axis wider than
1 is not ported yet (ROADMAP.md §1, slice 15) and
:func:`check_data_parallel` refuses it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

from ..config import MeshConfig

MODEL_AXIS_TODO = ("the 'model' (tensor-parallel) mesh axis is not ported to "
                   "litemkd_torch yet (ROADMAP.md §1, slice 15); run with "
                   "--mesh_model 1")


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


def check_data_parallel(mesh: Mesh) -> Mesh:
    """``mesh`` if the port can run it (a ``model`` axis of 1), else
    NotImplementedError naming the slice that will port it."""
    if mesh.model > 1:
        raise NotImplementedError(f"mesh {mesh.data}x{mesh.model}: "
                                  f"{MODEL_AXIS_TODO}")
    return mesh

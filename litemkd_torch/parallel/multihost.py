"""Processes under ``torchrun``: the process group, each rank's episode
shard and its random stream (port of ``litemkd_tpu/parallel/multihost.py``).

The JAX package runs one process per host and assembles a global batch from
the processes' shards (``jax.make_array_from_process_local_data``). The port
runs one process per card: ``torchrun`` starts them and sets ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, and
:func:`init_distributed` joins them in one process group, NCCL between
cards and gloo on the CPU. Each rank draws the ``E / data`` episodes of its
data index d from :func:`host_rng` ``(seed, d, step)``, the JAX package's
key, so that the episodes of data index d are byte for byte those of JAX
process d, and the global batch is the replicas' shards in data order; the
ranks of one model group draw the same episodes. Without a model axis d
is the rank.

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m litemkd_torch.cli.train --preset tiny --dataset synthetic \\
        --device cpu --mesh_data 2 -c /tmp/dp
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m litemkd_torch.cli.train --preset tiny --dataset synthetic \\
        --device cpu --mesh_data 2 --mesh_model 2 -c /tmp/tp
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, MeshGroups


@dataclass(frozen=True)
class DataParallel:
    """This process's place in the group: its ``rank`` of ``world`` and the
    ``device`` it runs on, the ``mesh`` that lays the ranks out (``data``
    replicas of ``model`` shards; by default every rank a replica) with
    this rank's process groups (``groups``, None while every rank is a
    replica: the default group then serves), and the collectives of the
    data-parallel paths, over the replicas of this rank's model index
    (they run at one replica too)."""

    rank: int
    world: int
    device: torch.device
    mesh: Optional[Mesh] = None
    groups: Optional[MeshGroups] = None

    @property
    def layout(self) -> Mesh:
        return self.mesh or Mesh(self.world, 1)

    @property
    def data(self) -> int:
        """Replicas: the size of the data axis."""
        return self.layout.data

    @property
    def model(self) -> int:
        """Shards of a replica: the size of the model axis."""
        return self.layout.model

    @property
    def data_index(self) -> int:
        return self.layout.coords(self.rank)[0]

    @property
    def model_index(self) -> int:
        return self.layout.coords(self.rank)[1]

    @property
    def data_group(self):
        return None if self.groups is None else self.groups.data

    @property
    def axis(self):
        """The :class:`~litemkd_torch.parallel.tensor_parallel.ModelAxis`
        of this rank's model group, or None without a model axis."""
        if self.model == 1:
            return None
        from .tensor_parallel import ModelAxis
        return ModelAxis(self.groups.model, self.model, self.model_index)

    def with_mesh(self, mesh: Mesh) -> "DataParallel":
        """This rank over ``mesh``: with a model axis, every data and model
        group is created (a collective over the world)."""
        groups = mesh.groups(self.rank) if mesh.model > 1 else None
        return replace(self, mesh=mesh, groups=groups)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the replicas, in place."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every replica's ``t`` (of one shape on all), concatenated along
        the first axis in data order, on every rank."""
        parts = [torch.empty_like(t) for _ in range(self.data)]
        dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.cat(parts)

    def barrier(self) -> None:
        dist.barrier()


def under_torchrun() -> bool:
    """Whether this process was started by ``torchrun`` (or with its
    environment)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device) -> Optional[DataParallel]:
    """Join the process group that ``torchrun``'s environment describes and
    return this rank's :class:`DataParallel`, or None outside ``torchrun``.
    On ``cuda`` the rank takes card ``cuda:{LOCAL_RANK}`` and NCCL; on the
    CPU, gloo. A group that is already set up is reused. At a world size of
    1 the group still forms, so that the collectives run (over one rank)."""
    if not under_torchrun():
        return None
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, **kw)
    return DataParallel(dist.get_rank(), dist.get_world_size(), device)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def local_episode_count(global_episodes: int, world: int) -> int:
    """Episodes each of ``world`` ranks draws for a global batch."""
    if global_episodes % world != 0:
        raise ValueError(f"global batch {global_episodes} not divisible by "
                         f"{world} processes")
    return global_episodes // world


def host_rng(seed: int, rank: int,
             step: Optional[int] = None) -> np.random.Generator:
    """Rank ``rank``'s numpy stream (and step ``step``'s, where given): the
    key of the JAX package's ``host_rng`` for process ``rank``."""
    key = (seed, rank) if step is None else (seed, rank, step)
    return np.random.default_rng(key)


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s equal slice of the leading (episode) axis of a numpy
    EpisodeBatch (fields may be None or ``{modality: array}``)."""
    def cut(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        n = local_episode_count(x.shape[0], world)
        return x[rank * n:(rank + 1) * n]

    return type(batch)(*(cut(x) for x in batch))


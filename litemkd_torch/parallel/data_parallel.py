"""Data-parallel training over the replicas of a mesh: what each rank
does around the one-process step so that a step of ``data`` replicas, each
on its ``E / data`` episodes, equals the JAX package's step on the
replicas' shards concatenated in data order (its ``data``-sharded step,
``litemkd_tpu/train/steps.py:136-211`` under a mesh). Without a model
axis a replica is a rank; with one (:mod:`.tensor_parallel`) every
reduction here runs over the data group of the rank's model index, so each
shard is summed with its own kind.

- **Gradients are summed** over the ranks, not averaged: the loss is the
  SUM of the per-episode losses (the reference sums 16 episodes before it
  steps), so the global gradient is the sum of the ranks' gradients.
- **Metrics**: ``task_loss`` is summed over the ranks; every other metric
  is the mean of the ranks' values (each is a mean over a rank's equal
  share of the chunks, or of one chunk's episodes).
- **BatchNorm.** The JAX package takes batch moments per micro-batch chunk
  of the global batch. Two layouts are ported (:func:`chunk_layout`):

  - ``"span"``: one chunk of the whole batch (``micro_batch`` 0, or at
    least E), which spans every rank. Its moments are summed over the ranks
    (:func:`~litemkd_torch.ops.batch_norm.synced_moments`: the BN-moment
    kernels' sums all-reduced, forward and backward, with or without
    ``pallas_bn``), so every rank updates the running statistics alike.
  - ``"local"``: chunks of ``micro_batch`` episodes that each lie inside
    one rank (``micro_batch`` divides ``E / world``). Moments stay local.
    The running statistics are an EMA taken chunk by chunk in global
    order; an update is affine, so after the step each rank's change from
    the common start is gathered and the global chain is rebuilt from them
    (:func:`reconcile_running_stats`).

  A chunk that spans some ranks but not all raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..ops.batch_norm import BatchNorm
from .multihost import DataParallel, local_episode_count


def replicas(dp) -> int:
    """The data replicas of a rank's group: its mesh's ``data`` axis (every
    rank where the group has no mesh)."""
    return getattr(dp, "data", dp.world)


def chunk_layout(micro: int, episodes: int, world: int) -> str:
    """``"span"`` or ``"local"`` (see the module note) for a batch of
    ``episodes`` in chunks of ``micro`` over ``world`` replicas; raises on a
    chunk that would span only some of them."""
    local = local_episode_count(episodes, world)
    if not micro or micro >= episodes:
        return "span"
    if local % micro == 0:
        return "local"
    raise ValueError(
        f"micro_batch {micro} over {world} ranks of {local} episodes each: "
        "a chunk would span some ranks but not all, and the port's "
        "data-parallel BatchNorm takes a chunk inside one rank or across "
        "all of them (ROADMAP.md §3); pick a micro_batch that divides "
        f"{local}, or 0")


def check_sync_batch_norm(model: nn.Module, allowed=(BatchNorm,)) -> None:
    """Raise on a batch-statistics module of ``model`` that is not one of
    ``allowed``: the ``"span"`` layout synchronises the port's
    :class:`BatchNorm` alone, and the fusion teachers' step none."""
    other = sorted({type(m).__name__ for m in model.modules()
                    if isinstance(m, _BatchNorm)
                    and not isinstance(m, tuple(allowed))})
    if other:
        raise ValueError(f"{other} hold batch statistics that the "
                         "data-parallel step cannot synchronise")


def all_reduce_grads(model: nn.Module, dp: DataParallel) -> None:
    """Sum every parameter's ``.grad`` over the replicas, in one flat
    all-reduce per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = dp.all_reduce_(_flatten_dense_tensors(grads))
        for g, summed in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(summed)


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   dp: DataParallel) -> Dict[str, torch.Tensor]:
    """``task_loss`` summed over the replicas, every other scalar averaged."""
    names = list(metrics)
    flat = dp.all_reduce_(torch.stack([metrics[k].float() for k in names]))
    return {k: flat[i] if k == "task_loss" else flat[i] / dp.data
            for i, k in enumerate(names)}


def _running(model: nn.Module) -> List[_BatchNorm]:
    return [m for m in model.modules()
            if isinstance(m, _BatchNorm) and m.track_running_stats]


def snapshot_running_stats(model: nn.Module) -> List[Tuple[torch.Tensor, ...]]:
    """The running statistics and update counts before a step."""
    return [(m.running_mean.clone(), m.running_var.clone(),
             m.num_batches_tracked.clone()) for m in _running(model)]


def reconcile_running_stats(model: nn.Module, before, dp: DataParallel) -> None:
    """Rebuild the global EMA of the running statistics from each rank's
    chain over its own chunks.

    A module updated n times on a rank with decay a = 1 − momentum goes
    from r₀ to r_k = aⁿ·r₀ + d_k. The chain over the ranks' chunks in
    global order is a^{nW}·r₀ + Σ_k a^{n(W−1−k)}·d_k: one all-gather of
    every rank's d_k gives it on every rank."""
    mods = _running(model)
    if not mods:
        return
    r0 = torch.cat([torch.cat([m0, v0]) for m0, v0, _ in before])
    now = torch.cat([torch.cat([m.running_mean, m.running_var]) for m in mods])
    decay = torch.cat([
        torch.pow(torch.full_like(m.running_mean, 1 - m.momentum),
                  (m.num_batches_tracked - n0).to(m.running_mean.dtype)
                  ).repeat(2)
        for m, (_, _, n0) in zip(mods, before)])
    d = dp.gather((now - decay * r0)[None])
    out = decay ** dp.data * r0
    for k in range(dp.data):
        out = out + decay ** (dp.data - 1 - k) * d[k]
    i = 0
    with torch.no_grad():
        for m, (_, _, n0) in zip(mods, before):
            c = m.running_mean.numel()
            m.running_mean.copy_(out[i:i + c])
            m.running_var.copy_(out[i + c:i + 2 * c])
            m.num_batches_tracked.copy_(
                n0 + (m.num_batches_tracked - n0) * dp.data)
            i += 2 * c

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
- **Metrics** are summed over the ranks (:func:`reduce_metrics`): each
  rank weighs its averaged metrics by its share of the batch beforehand.
- **BatchNorm.** The JAX package cuts the global batch into micro-batch
  chunks of ``micro_batch`` episodes (one chunk with 0) and takes each
  chunk's batch moments over the whole chunk, wherever its episodes lie.
  :func:`chunk_plan` lists this rank's pieces of the chunks: a chunk held
  by one replica has its moments taken there; a chunk spread over several
  (consecutive) replicas has its moment sums all-reduced over their
  process group (:func:`span_groups`;
  :func:`~litemkd_torch.ops.batch_norm.synced_moments` sets the group and
  the piece's share of the chunk's rows on every BatchNorm), forward and
  backward, so every replica of the chunk computes its moments. Each rank
  runs its pieces in chunk order, so the collectives of a chunk meet.
  Only the replica that holds a chunk's first episode keeps the chunk's
  running-statistics update; the EMA over the chunks in global order is
  then rebuilt from the ranks' chains (:func:`reconcile_running_stats`).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..ops.batch_norm import BatchNorm
from .multihost import DataParallel, local_episode_count


def replicas(dp) -> int:
    """The data replicas of a rank's group: its mesh's ``data`` axis (every
    rank where the group has no mesh)."""
    return getattr(dp, "data", dp.world)


class Piece(NamedTuple):
    """A rank's part of one micro-batch chunk: chunk ``chunk`` of ``size``
    episodes, of which this rank holds the global episodes ``[start,
    stop)``; ``members`` are the data indices that hold the chunk."""

    chunk: int
    size: int
    start: int
    stop: int
    members: range

    @property
    def episodes(self) -> int:
        return self.stop - self.start


def chunk_size(micro: int, episodes: int) -> int:
    """Episodes of a chunk: ``micro``, or the whole batch where it is 0 or
    at least the batch. Raises where it does not divide the batch."""
    size = micro if micro and micro < episodes else episodes
    if episodes % size:
        raise ValueError(f"micro_batch {micro} does not divide the "
                         f"{episodes} episodes of a batch")
    return size


def chunk_spans(micro: int, episodes: int, data: int) -> List[range]:
    """The data indices that hold each chunk of a batch of ``episodes`` in
    chunks of ``micro`` over ``data`` replicas, in chunk order."""
    size = chunk_size(micro, episodes)
    local = local_episode_count(episodes, data)
    return [range(c // local, (c + size - 1) // local + 1)
            for c in range(0, episodes, size)]


def chunk_plan(micro: int, episodes: int, data: int = 1,
               index: int = 0) -> List[Piece]:
    """The pieces of data index ``index``: the non-empty parts of the
    chunks that lie in its episodes ``[index·L, (index+1)·L)``, L =
    ``episodes / data``, in chunk order. Raises where the JAX package does:
    ``micro`` not dividing the batch, the batch not dividing over the
    replicas."""
    spans = chunk_spans(micro, episodes, data)
    size, local = episodes // len(spans), episodes // data
    pieces = []
    for c, span in enumerate(spans):
        start = max(c * size, index * local)
        stop = min((c + 1) * size, (index + 1) * local)
        if start < stop:
            pieces.append(Piece(c, size, start, stop, span))
    return pieces


def span_groups(dp: DataParallel, spans) -> Dict[range, object]:
    """The process group of each chunk span of ``spans`` with more than
    one member, over the ranks of those data indices at this rank's model
    index; a span of every replica is the data group itself. Every rank
    must call this with the same spans, in the same order:
    ``dist.new_group`` is a collective over the world, so each new span's
    group is made at every model index."""
    groups: Dict[range, object] = {}
    for span in dict.fromkeys(s for s in spans if len(s) > 1):
        if len(span) == dp.data:
            groups[span] = dp.data_group
            continue
        made = [dist.new_group([dp.layout.data_ranks(j)[i] for i in span])
                for j in range(dp.model)]
        groups[span] = made[dp.model_index]
    return groups


def check_sync_batch_norm(model: nn.Module, allowed=(BatchNorm,)) -> None:
    """Raise on a batch-statistics module of ``model`` that is not one of
    ``allowed``: a chunk over several replicas synchronises the port's
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
    """Every scalar summed over the replicas: ``task_loss`` is a sum, and
    each rank has weighed its averaged metrics by its share of the
    batch."""
    names = list(metrics)
    flat = dp.all_reduce_(torch.stack([metrics[k].float() for k in names]))
    return {k: flat[i] for i, k in enumerate(names)}


def _running(model: nn.Module) -> List[_BatchNorm]:
    return [m for m in model.modules()
            if isinstance(m, _BatchNorm) and m.track_running_stats]


def snapshot_running_stats(model: nn.Module) -> List[Tuple[torch.Tensor, ...]]:
    """The running statistics and update counts before a step."""
    return [(m.running_mean.clone(), m.running_var.clone(),
             m.num_batches_tracked.clone()) for m in _running(model)]


def reconcile_running_stats(model: nn.Module, before, dp: DataParallel) -> None:
    """Rebuild the global EMA of the running statistics from each rank's
    chain over the chunks it kept.

    A rank keeps the update of each chunk whose first episode it holds
    (:class:`Piece`), so its kept chunks are consecutive and the ranks' in
    data order are every chunk in global order. A module updated n times
    on a rank with decay a = 1 − momentum goes from r₀ to r = aⁿ·r₀ + d,
    an affine map: one all-gather of every rank's (d, aⁿ, n) lets each rank
    apply the ranks' maps in data order, and the update counts add up."""
    mods = _running(model)
    if not mods:
        return
    r0 = torch.cat([torch.cat([m0, v0]) for m0, v0, _ in before])
    now = torch.cat([torch.cat([m.running_mean, m.running_var]) for m in mods])
    counts = torch.stack([(m.num_batches_tracked - n0).to(r0.dtype)
                          for m, (_, _, n0) in zip(mods, before)])
    decay = torch.cat([
        torch.pow(torch.full_like(m.running_mean, 1 - m.momentum), n).repeat(2)
        for m, n in zip(mods, counts)])
    n = r0.numel()
    every = dp.gather(torch.cat([now - decay * r0, decay, counts])[None])
    out = r0
    for k in range(every.shape[0]):
        out = every[k, n:2 * n] * out + every[k, :n]
    total = every[:, 2 * n:].sum(dim=0)
    i = 0
    with torch.no_grad():
        for j, (m, (_, _, n0)) in enumerate(zip(mods, before)):
            c = m.running_mean.numel()
            m.running_mean.copy_(out[i:i + c])
            m.running_var.copy_(out[i + c:i + 2 * c])
            m.num_batches_tracked.copy_(n0 + total[j].round().long())
            i += 2 * c

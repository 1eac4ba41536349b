"""Episode batches, the train state, the distillation train step and the
student's and teacher's eval steps (port of
``litemkd_tpu/train/steps.py:31-250``).

The train step sums the named loss over the episodes of a batch, as the
reference sums 16 per-episode losses before it steps. With ``micro_batch``
the batch is cut into chunks that run in order at the same parameters:
their gradients add up in ``.grad`` and each chunk's BatchNorm updates its
running statistics in place, so the statistics chain from one chunk to the
next as the JAX package's ``lax.scan`` carries them. Over several replicas
a rank runs its pieces of the chunks (:func:`~litemkd_torch.parallel.
data_parallel.chunk_plan`); one process's pieces are the whole chunks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import Config
from ..distill import get_distiller, merge_logits
from ..models import BatchedStudent, BatchedTeacher, init_student_
from ..ops.batch_norm import Span, synced_moments
from ..ops.positional import bind_dropout_generator
from ..parallel.data_parallel import (all_reduce_grads, check_sync_batch_norm,
                                      chunk_plan, chunk_spans,
                                      reconcile_running_stats, reduce_metrics,
                                      replicas, snapshot_running_stats,
                                      span_groups)
from ..parallel.multihost import DataParallel
from ..parallel.tensor_parallel import (ModelAxis, shard_model,
                                        shard_optimizer_state_, squared_norm,
                                        sync_replicated_grads_)
from ..tools.weights import merge_state_dict
from ..utils.metrics import per_episode_accuracy
from ..utils.tracing import span
from .schedule import make_optimizer


class EpisodeBatch(NamedTuple):
    """One batch of episodes (leading axis E on every field).

    support_clips (E, S, T, H, W, 3)  uint8 pixels
    support_labels (E, S)             int in [0, way)
    query_clips  (E, Q, T, H, W, 3)
    query_labels (E, Q)
    support_feats (E, S, T, D)        fused teacher features (optional)
    query_feats  (E, Q, T, D)
    """

    support_clips: Any
    support_labels: Any
    query_clips: Any
    query_labels: Any
    support_feats: Any = None
    query_feats: Any = None


@dataclass
class TrainState:
    """What a training run carries from step to step (the counterpart of
    the JAX package's ``TrainState``): the update count, the episodes seen,
    the trained model and, for the student, the frozen teacher, the
    optimizer and its schedule, and the generators that draw the model's
    and the teacher's dropout masks. A run without a teacher (the MFM
    teacher's own training, the pretrain stage, a student trained on
    batches without teacher features) has ``teacher`` and
    ``teacher_generator`` None."""

    step: int
    episodes_seen: int
    model: torch.nn.Module
    teacher: Optional[BatchedTeacher]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    generator: torch.Generator
    teacher_generator: Optional[torch.Generator]


def dropout_seeds(seed: int) -> Tuple[int, int]:
    """The seeds of the trained model's and the teacher's dropout
    generators for a run of ``seed``."""
    return seed + 2, seed + 3


def create_train_state(cfg: Config, device, *,
                       student_state_dict: Optional[Dict] = None,
                       teacher_state_dict: Optional[Dict] = None,
                       episodes_per_step: Optional[int] = None,
                       with_teacher: bool = True) -> TrainState:
    """A fresh state on ``device``. The student gets random weights from
    ``cfg.train.seed``, with ``student_state_dict`` (reference layout,
    possibly PARTIAL: a trunk alone) laid over them
    (:func:`~litemkd_torch.tools.weights.merge_state_dict`). With
    ``with_teacher`` the frozen teacher gets random weights from seed + 1
    or ``teacher_state_dict`` (strict); without it (batches that carry no
    teacher features) there is none, as the JAX package's
    ``create_train_state`` leaves ``t_vars`` None. The dropout generators
    live on ``device``, seeded by :func:`dropout_seeds`. A float64
    ``compute_dtype`` (the tests' golden runs) holds both models'
    parameters in float64: torch does not promote a float64 input over
    float32 weights, as JAX does."""
    device = torch.device(device)
    dtype = torch.float64 if cfg.model.compute_dtype == "float64" else None
    seed = cfg.train.seed
    model = BatchedStudent(cfg)
    init_student_(model, torch.Generator().manual_seed(seed))
    if student_state_dict is not None:
        model.load_state_dict(merge_state_dict(model.state_dict(),
                                               student_state_dict), strict=True)
    model.to(device, dtype).train()
    model_seed, teacher_seed = dropout_seeds(seed)
    generator = torch.Generator(device=device).manual_seed(model_seed)
    bind_dropout_generator(model, generator)
    teacher = teacher_generator = None
    if with_teacher:
        teacher = BatchedTeacher(cfg)
        if teacher_state_dict is not None:
            teacher.load_state_dict(teacher_state_dict, strict=True)
        else:
            init_student_(teacher, torch.Generator().manual_seed(seed + 1))
        teacher.requires_grad_(False).to(device, dtype).train()
        teacher_generator = torch.Generator(device=device).manual_seed(teacher_seed)
        bind_dropout_generator(teacher, teacher_generator)
    opt, sched = make_optimizer(cfg.train.optimizer, model.parameters(),
                                cfg.train.learning_rate, cfg.train.sch,
                                cfg.train.sch_gamma,
                                episodes_per_step or cfg.train.tasks_per_batch)
    return TrainState(step=0, episodes_seen=0, model=model, teacher=teacher,
                      optimizer=opt, scheduler=sched, generator=generator,
                      teacher_generator=teacher_generator)


def _episode(x, i: int):
    if isinstance(x, dict):
        return {k: v[i] for k, v in x.items()}
    return x[i]


def _slice(batch: EpisodeBatch, lo: int, hi: int) -> EpisodeBatch:
    if lo == 0 and hi == batch.support_labels.shape[0]:
        return batch
    return EpisodeBatch(*(None if x is None else x[lo:hi] for x in batch))


def shard_train_state(state: TrainState, axis: Optional[ModelAxis]
                      ) -> TrainState:
    """Cut ``state`` over the model axis, in place: the trained model, the
    frozen teacher (the JAX package shards its variables by the same rules)
    and the optimizer's state. Nothing without an axis or where the model
    is cut already."""
    if axis is None or getattr(state.model, "tp_axis", None) is not None:
        return state
    shard_model(state.model, axis)
    shard_optimizer_state_(state.optimizer, axis)
    if state.teacher is not None:
        shard_model(state.teacher, axis)
    return state


def _global_norm(params, grads: bool, axis: Optional[ModelAxis]
                 ) -> torch.Tensor:
    """‖·‖ of the parameters (or their gradients), each counted once: a
    sharded one summed over its model group, a replicated one taken
    once."""
    return torch.sqrt(squared_norm(
        [p.grad if grads else p.detach() for p in params],
        [getattr(p, "tp_spec", None) is not None for p in params], axis))


def make_train_step(cfg: Config, dp: Optional[DataParallel] = None
                    ) -> Callable:
    """``train_step(state, batch) → metrics``: one optimizer update on a
    batch of episodes, state updated in place. The metrics are device
    scalars: ``task_loss`` summed over the chunks, every other metric the
    mean of the per-chunk means; with ``cfg.train.watch`` also the global
    and per-top-module gradient and parameter norms (over the parameters
    the loss reaches).

    With ``dp`` (a rank of a process group) ``batch`` is the
    ``tasks_per_batch / data`` episodes of this rank's replica and the
    update is the one of the replicas' shards concatenated: gradients and
    metrics are reduced over the replicas, the BatchNorm moments of a chunk
    over several replicas summed over them and the running statistics
    rebuilt, as :mod:`litemkd_torch.parallel.data_parallel` sets out; the
    process groups of the chunks are made here, on every rank. Every
    layout the JAX package takes runs; ``micro_batch`` must divide the
    batch. With a model axis the state must be cut over it
    (:func:`shard_train_state`, which :func:`~litemkd_torch.train.loop.
    train_loop` applies); the watched norms count each shard once."""
    distill = get_distiller(cfg.distill.name)
    dcfg = cfg.distill
    tpb = cfg.train.tasks_per_batch
    micro = cfg.train.micro_batch
    watch = cfg.train.watch
    world = replicas(dp) if dp is not None else 1
    index = dp.data_index if dp is not None else 0
    axis = dp.axis if dp is not None else None
    groups = (span_groups(dp, chunk_spans(micro, tpb, world))
              if dp is not None else {})

    def chunk_loss(state: TrainState, chunk: EpisodeBatch):
        out = state.model(chunk.support_clips, chunk.support_labels,
                          chunk.query_clips)
        s_logits = out["logits"]
        t_logits = None
        if state.teacher is not None:
            with span("teacher"), torch.no_grad():
                t_logits = state.teacher(chunk.support_feats, chunk.support_labels,
                                         chunk.query_feats)["logits"]
        with span("loss"):
            # teacher-free losses (ce, TRXLoss) ignore the teacher argument
            per_ep = [distill(_episode(s_logits, i),
                              None if t_logits is None else _episode(t_logits, i),
                              chunk.query_labels[i], dcfg, tpb)
                      for i in range(chunk.support_labels.shape[0])]
            stacked = {k: torch.stack([p[k] for p in per_ep]) for k in per_ep[0]}
            total = stacked["loss"].sum()
            merged = merge_logits(cfg.distill.name, s_logits)
            acc = per_episode_accuracy(merged, chunk.query_labels)
            metrics = {"task_loss": total.detach(), "accuracy": acc.mean()}
            for k, v in stacked.items():
                if k != "loss":
                    metrics[k] = v.detach().mean()
        return total, metrics

    def train_step(state: TrainState, batch: EpisodeBatch) -> Dict[str, Any]:
        with span("step"):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: EpisodeBatch) -> Dict[str, Any]:
        state.model.train()
        if state.teacher is not None:
            state.teacher.train()
        with span("optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        e = batch.support_labels.shape[0]
        if dp is not None and e * world != tpb:
            raise ValueError(f"{e} episodes on each of {world} replicas; the "
                             f"step was built for {tpb}")
        plan = chunk_plan(micro, e * world, world, index)
        if groups:
            check_sync_batch_norm(state.model)
        before = snapshot_running_stats(state.model) if world > 1 else None
        sums: Dict[str, torch.Tensor] = {}
        for piece in plan:
            rows = (Span(groups[piece.members], piece.episodes, piece.size)
                    if len(piece.members) > 1 else None)
            lo = piece.start - index * e
            # the chunk's first replica keeps its running-statistics update
            first = piece.start == piece.chunk * piece.size
            with synced_moments(state.model, rows, keep_stats=first):
                loss, m = chunk_loss(state, _slice(batch, lo, lo + piece.episodes))
                with span("backward"):
                    loss.backward()
            # an averaged metric of a piece weighs as its share of its chunk
            share = piece.episodes / piece.size
            for k, v in m.items():
                v = v if k == "task_loss" else v * share
                sums[k] = sums[k] + v if k in sums else v
        chunks = e * world // plan[0].size
        metrics = {k: (v if k == "task_loss" else v / chunks)
                   for k, v in sums.items()}
        if dp is not None:
            sync_replicated_grads_(state.model, axis)
            all_reduce_grads(state.model, dp)
            metrics = reduce_metrics(metrics, dp)
            if before is not None:
                reconcile_running_stats(state.model, before, dp)
        if watch:
            named = [(n, p) for n, p in state.model.named_parameters()
                     if p.grad is not None]
            params = [p for _, p in named]
            metrics["grad_norm"] = _global_norm(params, True, axis)
            metrics["param_norm"] = _global_norm(params, False, axis)
            for top in dict.fromkeys(n.split(".")[0] for n, _ in named):
                sub = [p for n, p in named if n.split(".")[0] == top]
                metrics[f"grad_norm/{top}"] = _global_norm(sub, True, axis)
                metrics[f"param_norm/{top}"] = _global_norm(sub, False, axis)
        with span("optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        state.episodes_seen += batch.support_labels.shape[0] * world
        return metrics

    return train_step


def make_eval_step(cfg: Config, with_preds: bool = False) -> Callable:
    """Eval step: ``eval_step(model, batch) → (E,)`` per-episode accuracies
    of the merged branch logits, computed on the batch's device; with
    ``with_preds`` → ``((E,) accuracies, (E, Q) episode-local argmax
    predictions)`` for the per-task confusion analysis (the reference's
    ``test.py:160-201``)."""

    def eval_step(model: torch.nn.Module, batch: EpisodeBatch):
        with torch.inference_mode():
            out = model(batch.support_clips, batch.support_labels,
                        batch.query_clips)
            merged = merge_logits(cfg.distill.name, out["logits"])
            acc = per_episode_accuracy(merged, batch.query_labels)
            return (acc, merged.argmax(dim=-1)) if with_preds else acc

    return eval_step


def make_teacher_eval_step(cfg: Config, with_preds: bool = False) -> Callable:
    """Eval step of the frozen teacher itself on feature episodes (the
    reference's ``test.py`` teacher mode, l.107-110):
    ``eval_step(teacher, batch)`` scores the teacher's ``kl`` logits (the
    first branch of a head without one) against the query labels; returns
    what :func:`make_eval_step`'s step does."""

    def eval_step(teacher: torch.nn.Module, batch: EpisodeBatch):
        with torch.inference_mode():
            logits = teacher(batch.support_feats, batch.support_labels,
                             batch.query_feats)["logits"]
            if isinstance(logits, dict):
                logits = logits["kl"] if "kl" in logits else \
                    next(iter(logits.values()))
            acc = per_episode_accuracy(logits, batch.query_labels)
            return (acc, logits.argmax(dim=-1)) if with_preds else acc

    return eval_step

"""Training and evaluation drivers, on one device or as one rank of a
data- and tensor-parallel run (port of ``run_eval`` and ``run_training``,
``litemkd_tpu/train/loop.py:25-305``).

Eval: chunks are ``batch_size`` episodes plus at most one remainder chunk,
drawn in chunk order from one ``np.random.default_rng(seed)``, so the port
and the JAX package evaluate the same episodes.

Training: batch i of a run that starts at update ``start_step`` is drawn
from ``np.random.default_rng((seed, start_step + i))``, the JAX package's
stream, so both packages train on the same episodes, resume included.
Iteration counts are in episodes, as in the reference.

Host work overlaps the device in both: a :class:`Prefetcher` thread
assembles the next batch and copies it from pinned memory while the device
runs the current one, and :class:`DeferredHostSync` reads step i's results
only after step i+1 is enqueued.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.prefetch import DeferredHostSync, Prefetcher
from ..parallel.data_parallel import replicas
from ..parallel.multihost import (DataParallel, host_rng, local_episode_count,
                                  shard_batch)
from ..utils.logging import MetricsLogger
from ..utils.metrics import TestAccuracies, real_class_preds
from .checkpoint import CheckpointManager
from .steps import (EpisodeBatch, TrainState, create_train_state,
                    make_eval_step, make_train_step, shard_train_state)


def move_to_device(x, device: torch.device):
    """A numpy array, a dict of them, or None → tensors on ``device``; CUDA
    copies go from pinned host memory without blocking the host. int32
    becomes int64."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: move_to_device(v, device) for k, v in x.items()}
    t = torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype == torch.int32:
        t = t.long()
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(batch: EpisodeBatch, device: torch.device) -> EpisodeBatch:
    """numpy batch → tensors on ``device`` (:func:`move_to_device`); a
    field that is a dict (the MFM's per-modality features) moves entry by
    entry."""
    return EpisodeBatch(*(move_to_device(x, device) for x in batch))


def run_eval(cfg: Config, model: torch.nn.Module, sampler, *,
             n_tasks: Optional[int] = None, batch_size: int = 8, seed: int = 0,
             eval_step: Optional[Callable] = None,
             device: Optional[torch.device] = None, specs=None,
             task_log: Optional[Callable[[dict], None]] = None,
             dp: Optional[DataParallel] = None) -> dict:
    """Episodic evaluation: mean accuracy ×100 with the 196·std/√n CI.

    ``model`` is an eval-mode ``BatchedStudent``, a ``BatchedTeacher`` with
    the teacher eval step, or an ``MFMTeacher`` with the MFM eval step;
    ``device`` defaults to the device of its parameters.
    ``eval_step(model, batch) → (E,)`` accuracies defaults to
    :func:`make_eval_step`. With ``specs`` (fixed episodes, at least
    ``n_tasks`` of them) chunk i replays its slice of them.

    ``task_log`` is called once per episode, in task order, with the record
    ``{task, accuracy, classes, real_labels, real_preds}``: the reference's
    per-task analysis stream (``test.py:232``, ``utils.py:123-127``). It
    needs a sampler that returns episode metadata and an ``eval_step``
    built with ``with_preds`` (the default step is).

    With ``dp`` over more than one replica every rank draws each chunk
    from the same stream and evaluates the equal slice of it of its
    replica (the ranks of a model group, whose ``model`` is cut over them,
    the same slice); the accuracies (and predictions) are gathered over
    the replicas to every rank in task order, so the summary is a
    one-process eval's and ``task_log`` sees every task on every rank.
    Chunks must then divide over the replicas: as the JAX package's
    multi-process eval does, ``batch_size`` is rounded down to a multiple
    of the data axis and ``n_tasks`` to whole chunks, loudly."""
    n_tasks = n_tasks or cfg.train.num_test_tasks
    eval_step = eval_step or make_eval_step(cfg, with_preds=task_log is not None)
    device = device or next(model.parameters()).device
    rng = np.random.default_rng(seed)
    world = replicas(dp) if dp is not None else 1
    if world > 1:
        batch_size = max(batch_size // world, 1) * world
        if n_tasks % batch_size:
            rounded = max(batch_size, n_tasks - n_tasks % batch_size)
            if dp.rank == 0:
                print(f"[eval] {world} ranks: rounding n_tasks {n_tasks} → "
                      f"{rounded} (chunks of {batch_size} over {world} ranks)")
            n_tasks = rounded
    sizes = [batch_size] * (n_tasks // batch_size)
    if n_tasks % batch_size:
        sizes.append(n_tasks % batch_size)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    metas: Dict[int, object] = {}

    def produce(i: int) -> EpisodeBatch:
        kw = {} if specs is None else {
            "specs": specs[offsets[i]:offsets[i] + sizes[i]]}
        if task_log is None:
            batch = sampler.sample_batch(rng, sizes[i], train=False, **kw)
        else:
            batch, metas[i] = sampler.sample_batch(rng, sizes[i], train=False,
                                                   return_meta=True, **kw)
        return batch if world == 1 else shard_batch(batch, dp.data_index,
                                                    world)

    acc = TestAccuracies()

    def absorb(i: int, out) -> None:
        accs, preds = out if task_log is not None else (out, None)
        accs = accs.cpu().numpy()
        acc.extend(accs)
        if task_log is None:
            return
        meta = metas.pop(i)
        real_preds = real_class_preds(preds.cpu(),
                                      torch.from_numpy(meta.classes)).numpy()
        for e in range(accs.shape[0]):
            task_log({"task": offsets[i] + e,
                      "accuracy": float(accs[e]),
                      "classes": meta.classes[e].tolist(),
                      "real_labels": meta.real_query_labels[e].tolist(),
                      "real_preds": real_preds[e].tolist()})

    deferred = DeferredHostSync(absorb)
    for i, batch in enumerate(Prefetcher(produce, len(sizes),
                                         transfer=lambda b: to_device(b, device))):
        out = eval_step(model, batch)
        if world > 1:
            out = (tuple(dp.gather(t) for t in out) if task_log is not None
                   else dp.gather(out))
        deferred.push(i, out)
    deferred.flush()
    return acc.summary()


def run_training(cfg: Config, sampler, logger: Optional[MetricsLogger] = None,
                 *, device=None, teacher_state_dict: Optional[Dict] = None,
                 student_state_dict: Optional[Dict] = None,
                 eval_sampler=None, dp: Optional[DataParallel] = None
                 ) -> Tuple[TrainState, List[dict]]:
    """Student training for ``cfg.train.training_iterations`` episodes in
    batches of ``tasks_per_batch``; returns ``(state, eval_history)``.

    ``sampler.sample_batch(rng, n, train)`` yields numpy EpisodeBatches;
    where ``sampler.with_teacher_feats`` is false they carry no teacher
    features and the student trains teacher-free, as in the JAX package.
    ``student_state_dict`` (reference layout, possibly a trunk alone) and
    ``teacher_state_dict`` warm-start the models; otherwise they get random
    weights from the seed.
    With ``cfg.train.checkpoint_dir`` a checkpoint is written every
    ``save_freq`` episodes and at the end, and ``resume_from_checkpoint``
    continues from the newest one. At each of ``test_iters`` the student is
    evaluated (eval mode, seed 0, ``num_test_tasks`` episodes) through
    :func:`run_eval`. ``device`` defaults to cuda. With ``dp`` the run is
    this rank's part of a data-parallel run (:func:`train_loop`)."""
    device = torch.device(device or "cuda")
    state = create_train_state(cfg, device,
                               student_state_dict=student_state_dict,
                               teacher_state_dict=teacher_state_dict,
                               episodes_per_step=cfg.train.tasks_per_batch,
                               with_teacher=sampler.with_teacher_feats)
    history = train_loop(cfg, state, sampler, make_train_step(cfg, dp),
                         make_eval_step(cfg), logger, device=device,
                         eval_sampler=eval_sampler, dp=dp)
    return state, history


def train_loop(cfg: Config, state: TrainState, sampler, train_step: Callable,
               eval_step: Callable, logger: Optional[MetricsLogger] = None, *,
               device, eval_sampler=None,
               dp: Optional[DataParallel] = None) -> List[dict]:
    """The training loop that the student and the MFM teacher share:
    ``train_step(state, batch)`` on batches of ``tasks_per_batch`` episodes
    until ``cfg.train.training_iterations`` episodes, evaluation at each of
    ``test_iters`` through :func:`run_eval` with ``eval_step`` (eval mode,
    seed 0, ``num_test_tasks`` episodes), and checkpoints (every
    ``save_freq`` episodes and at the end) when ``cfg.train.checkpoint_dir``
    is set; with ``resume_from_checkpoint`` the newest one is restored into
    ``state`` first. Returns the eval history.

    With ``dp`` (a rank of a process group, ``train_step`` built with it)
    and more than one replica, the ranks of replica d draw its
    ``tasks_per_batch / data`` episodes of update i from
    :func:`~litemkd_torch.parallel.host_rng` ``(seed, d, start_step + i)``,
    the JAX package's multi-process stream; evaluation is sharded
    (:func:`run_eval`); every rank restores a checkpoint and rank 0 alone
    writes them. With a model axis the state is cut over it after the
    restore (:func:`shard_train_state`), and a checkpoint is gathered back
    to the one-process layout before rank 0 writes it. At one replica the
    stream is the one-process stream, so a run equals a plain one."""
    logger = logger or MetricsLogger(print_freq=cfg.train.print_freq)
    eval_sampler = eval_sampler or sampler
    e_per_step = cfg.train.tasks_per_batch
    n_steps = max(1, cfg.train.training_iterations // e_per_step)
    ckpt = None
    if cfg.train.checkpoint_dir:
        ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        if cfg.train.resume_from_checkpoint and ckpt.latest_step() is not None:
            ckpt.restore(state, cfg.train.seed)
            logger.info(f"resumed at {state.episodes_seen} episodes")
    shard_train_state(state, dp.axis if dp is not None else None)

    test_marks = sorted(m for m in cfg.train.test_iters
                        if m > state.episodes_seen)
    save_every = max(1, cfg.train.save_freq // e_per_step)
    eval_history: List[dict] = []
    start_step = state.step

    world = replicas(dp) if dp is not None else 1
    writer = dp is None or dp.rank == 0

    def produce(i: int) -> EpisodeBatch:
        if world > 1:
            return sampler.sample_batch(
                host_rng(cfg.train.seed, dp.data_index, start_step + i),
                local_episode_count(e_per_step, world), train=True)
        return sampler.sample_batch(
            np.random.default_rng((cfg.train.seed, start_step + i)),
            e_per_step, train=True)

    deferred = DeferredHostSync(lambda step, episodes, metrics: logger.log(
        step, {k: float(v) for k, v in metrics.items()} | {"episodes": episodes}))
    for batch in Prefetcher(produce, n_steps - start_step,
                            transfer=lambda b: to_device(b, device)):
        metrics = train_step(state, batch)
        deferred.push(state.step, state.episodes_seen, metrics)

        if ckpt and state.step % save_every == 0:
            deferred.flush()
            ckpt.save(state, write=writer)

        while test_marks and state.episodes_seen >= test_marks[0]:
            test_marks.pop(0)
            deferred.flush()
            summary = run_eval(cfg, state.model.eval(), eval_sampler,
                               eval_step=eval_step, device=device, dp=dp)
            state.model.train()
            eval_history.append({"episodes": state.episodes_seen, **summary})
            logger.info(f"eval @{state.episodes_seen} episodes: "
                        f"{summary['accuracy']:.2f} ± "
                        f"{summary['confidence']:.2f} "
                        f"({summary['n_tasks']} tasks)")
    deferred.flush()
    if ckpt:
        ckpt.save(state, write=writer)
    if dp is not None:
        dp.barrier()     # every checkpoint is on disk when the ranks return
    return eval_history

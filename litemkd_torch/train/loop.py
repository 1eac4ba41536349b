"""Training and evaluation drivers on one device (port of ``run_eval`` and
``run_training``, ``litemkd_tpu/train/loop.py:25-305``).

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
from ..utils.logging import MetricsLogger
from ..utils.metrics import TestAccuracies
from .checkpoint import CheckpointManager
from .steps import (EpisodeBatch, TrainState, create_train_state,
                    make_eval_step, make_train_step)


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
             device: Optional[torch.device] = None, specs=None) -> dict:
    """Episodic evaluation: mean accuracy ×100 with the 196·std/√n CI.

    ``model`` is an eval-mode ``BatchedStudent``, or an ``MFMTeacher`` with
    the MFM eval step; ``device`` defaults to the device of its parameters.
    ``eval_step(model, batch) → (E,)`` accuracies defaults to
    :func:`make_eval_step`. With ``specs`` (fixed episodes, at least
    ``n_tasks`` of them) chunk i replays its slice of them."""
    n_tasks = n_tasks or cfg.train.num_test_tasks
    eval_step = eval_step or make_eval_step(cfg)
    device = device or next(model.parameters()).device
    rng = np.random.default_rng(seed)
    sizes = [batch_size] * (n_tasks // batch_size)
    if n_tasks % batch_size:
        sizes.append(n_tasks % batch_size)
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]

    def produce(i: int) -> EpisodeBatch:
        if specs is None:
            return sampler.sample_batch(rng, sizes[i], train=False)
        return sampler.sample_batch(rng, sizes[i], train=False,
                                    specs=specs[offsets[i]:offsets[i] + sizes[i]])

    acc = TestAccuracies()
    deferred = DeferredHostSync(lambda accs: acc.extend(accs.cpu().numpy()))
    for batch in Prefetcher(produce, len(sizes),
                            transfer=lambda b: to_device(b, device)):
        deferred.push(eval_step(model, batch))
    deferred.flush()
    return acc.summary()


def run_training(cfg: Config, sampler, logger: Optional[MetricsLogger] = None,
                 *, device=None, teacher_state_dict: Optional[Dict] = None,
                 student_state_dict: Optional[Dict] = None,
                 eval_sampler=None) -> Tuple[TrainState, List[dict]]:
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
    :func:`run_eval`. ``device`` defaults to cuda."""
    device = torch.device(device or "cuda")
    state = create_train_state(cfg, device,
                               student_state_dict=student_state_dict,
                               teacher_state_dict=teacher_state_dict,
                               episodes_per_step=cfg.train.tasks_per_batch,
                               with_teacher=sampler.with_teacher_feats)
    history = train_loop(cfg, state, sampler, make_train_step(cfg),
                         make_eval_step(cfg), logger, device=device,
                         eval_sampler=eval_sampler)
    return state, history


def train_loop(cfg: Config, state: TrainState, sampler, train_step: Callable,
               eval_step: Callable, logger: Optional[MetricsLogger] = None, *,
               device, eval_sampler=None) -> List[dict]:
    """The training loop that the student and the MFM teacher share:
    ``train_step(state, batch)`` on batches of ``tasks_per_batch`` episodes
    until ``cfg.train.training_iterations`` episodes, evaluation at each of
    ``test_iters`` through :func:`run_eval` with ``eval_step`` (eval mode,
    seed 0, ``num_test_tasks`` episodes), and checkpoints (every
    ``save_freq`` episodes and at the end) when ``cfg.train.checkpoint_dir``
    is set; with ``resume_from_checkpoint`` the newest one is restored into
    ``state`` first. Returns the eval history."""
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

    test_marks = sorted(m for m in cfg.train.test_iters
                        if m > state.episodes_seen)
    save_every = max(1, cfg.train.save_freq // e_per_step)
    eval_history: List[dict] = []
    start_step = state.step

    def produce(i: int) -> EpisodeBatch:
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
            ckpt.save(state)

        while test_marks and state.episodes_seen >= test_marks[0]:
            test_marks.pop(0)
            deferred.flush()
            summary = run_eval(cfg, state.model.eval(), eval_sampler,
                               eval_step=eval_step, device=device)
            state.model.train()
            eval_history.append({"episodes": state.episodes_seen, **summary})
            logger.info(f"eval @{state.episodes_seen} episodes: "
                        f"{summary['accuracy']:.2f} ± "
                        f"{summary['confidence']:.2f} "
                        f"({summary['n_tasks']} tasks)")
    deferred.flush()
    if ckpt:
        ckpt.save(state)
    return eval_history

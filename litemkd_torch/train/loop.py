"""Training and evaluation drivers on one device (port of ``run_eval`` and
``run_training``, ``litemkd_tpu/train/loop.py:25-305``).

Eval: chunks are ``batch_size`` episodes plus at most one remainder chunk,
drawn in chunk order from one ``np.random.default_rng(seed)``, so the port
and the JAX package evaluate the same episodes.

Training: batch i of a run that starts at update ``start_step`` is drawn
from ``np.random.default_rng((seed, start_step + i))``, the JAX package's
stream, so both packages train on the same episodes, resume included.
Iteration counts are in episodes, as in the reference.

Host work overlaps the device in both: step i is enqueued, batch i+1 is
drawn and copied from pinned memory while the device runs, and only then
are step i's results read.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..utils.logging import MetricsLogger
from ..utils.metrics import TestAccuracies
from .checkpoint import CheckpointManager
from .steps import (EpisodeBatch, TrainState, create_train_state,
                    make_eval_step, make_train_step)


def to_device(batch: EpisodeBatch, device: torch.device) -> EpisodeBatch:
    """numpy batch → tensors on ``device``; CUDA copies go from pinned host
    memory without blocking the host. Integer labels become int64."""
    device = torch.device(device)

    def move(x):
        if x is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return EpisodeBatch(*(move(x) for x in batch))


def run_eval(cfg: Config, model: torch.nn.Module, sampler, *,
             n_tasks: Optional[int] = None, batch_size: int = 8, seed: int = 0,
             eval_step: Optional[Callable] = None,
             device: Optional[torch.device] = None) -> dict:
    """Episodic evaluation: mean accuracy ×100 with the 196·std/√n CI.

    ``model`` is an eval-mode ``BatchedStudent``; ``device`` defaults to the
    device of its parameters. ``eval_step(model, batch) → (E,)``
    accuracies defaults to :func:`make_eval_step`."""
    n_tasks = n_tasks or cfg.train.num_test_tasks
    eval_step = eval_step or make_eval_step(cfg)
    device = device or next(model.parameters()).device
    rng = np.random.default_rng(seed)
    sizes = [batch_size] * (n_tasks // batch_size)
    if n_tasks % batch_size:
        sizes.append(n_tasks % batch_size)

    acc = TestAccuracies()
    pending = None
    nxt = to_device(sampler.sample_batch(rng, sizes[0], train=False), device)
    for i in range(len(sizes)):
        accs = eval_step(model, nxt)          # enqueued; runs while we draw
        if i + 1 < len(sizes):
            nxt = to_device(sampler.sample_batch(rng, sizes[i + 1], train=False),
                            device)
        if pending is not None:
            acc.extend(pending.cpu().numpy())
        pending = accs
    acc.extend(pending.cpu().numpy())
    return acc.summary()


def run_training(cfg: Config, sampler, logger: Optional[MetricsLogger] = None,
                 *, device=None, teacher_state_dict: Optional[Dict] = None,
                 student_state_dict: Optional[Dict] = None,
                 eval_sampler=None) -> Tuple[TrainState, List[dict]]:
    """Student training for ``cfg.train.training_iterations`` episodes in
    batches of ``tasks_per_batch``; returns ``(state, eval_history)``.

    ``sampler.sample_batch(rng, n, train)`` yields numpy EpisodeBatches.
    ``student_state_dict`` / ``teacher_state_dict`` (reference layout)
    warm-start the models; otherwise they get random weights from the seed.
    With ``cfg.train.checkpoint_dir`` a checkpoint is written every
    ``save_freq`` episodes and at the end, and ``resume_from_checkpoint``
    continues from the newest one. At each of ``test_iters`` the student is
    evaluated (eval mode, seed 0, ``num_test_tasks`` episodes) through
    :func:`run_eval`. ``device`` defaults to cuda."""
    device = torch.device(device or "cuda")
    logger = logger or MetricsLogger(print_freq=cfg.train.print_freq)
    eval_sampler = eval_sampler or sampler
    e_per_step = cfg.train.tasks_per_batch
    n_steps = max(1, cfg.train.training_iterations // e_per_step)

    state = create_train_state(cfg, device,
                               student_state_dict=student_state_dict,
                               teacher_state_dict=teacher_state_dict,
                               episodes_per_step=e_per_step)
    ckpt = None
    if cfg.train.checkpoint_dir:
        ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        if cfg.train.resume_from_checkpoint and ckpt.latest_step() is not None:
            ckpt.restore(state)
            logger.info(f"resumed at {state.episodes_seen} episodes")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    test_marks = sorted(m for m in cfg.train.test_iters
                        if m > state.episodes_seen)
    save_every = max(1, cfg.train.save_freq // e_per_step)
    eval_history: List[dict] = []
    start_step = state.step

    def produce(i: int) -> EpisodeBatch:
        rng = np.random.default_rng((cfg.train.seed, start_step + i))
        return to_device(sampler.sample_batch(rng, e_per_step, train=True),
                         device)

    pending = []   # metrics of the last enqueued step, read one step late

    def flush():
        for step, episodes, metrics in pending:
            logger.log(step, {k: float(v) for k, v in metrics.items()}
                       | {"episodes": episodes})
        pending.clear()

    n_run = n_steps - start_step
    nxt = produce(0) if n_run > 0 else None
    for i in range(n_run):
        metrics = train_step(state, nxt)          # enqueued; runs while we draw
        if i + 1 < n_run:
            nxt = produce(i + 1)
        flush()
        pending.append((state.step, state.episodes_seen, metrics))

        if ckpt and state.step % save_every == 0:
            flush()
            ckpt.save(state)

        while test_marks and state.episodes_seen >= test_marks[0]:
            test_marks.pop(0)
            flush()
            summary = run_eval(cfg, state.model.eval(), eval_sampler,
                               eval_step=eval_step, device=device)
            state.model.train()
            eval_history.append({"episodes": state.episodes_seen, **summary})
            logger.info(f"eval @{state.episodes_seen} episodes: "
                        f"{summary['accuracy']:.2f} ± "
                        f"{summary['confidence']:.2f} "
                        f"({summary['n_tasks']} tasks)")
    flush()
    if ckpt:
        ckpt.save(state)
    return state, eval_history

"""Episodic evaluation driver (port of ``run_eval``,
``litemkd_tpu/train/loop.py:25-144``, on a single device).

Chunks are ``batch_size`` episodes plus at most one remainder chunk, drawn
in chunk order from one ``np.random.default_rng(seed)``, so the port and the
JAX package evaluate the same episodes. Host work overlaps the device: the
eval step of chunk i is enqueued, chunk i+1 is drawn and copied from pinned
memory while the device runs, and only then are chunk i's accuracies read.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import Config
from ..utils.metrics import TestAccuracies
from .steps import EpisodeBatch, make_eval_step


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

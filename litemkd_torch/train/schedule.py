"""Optimizer and LR schedule (port of ``litemkd_tpu/train/schedule.py``).

The reference steps ``MultiStepLR`` once per episode, with milestones in
episodes. The port steps once per batch of ``episodes_per_step`` episodes,
so each milestone m becomes the update ``max(1, m // episodes_per_step)``,
exactly as the JAX package's optax schedule sees it:

- milestones that land on the same update fold into ONE decay (the JAX
  package builds a dict keyed by update, so a repeated key decays once);
- update k (counted from 0) runs at ``base · γ^(#boundaries ≤ k)``: optax
  scales from the update whose count reaches the boundary.

``torch.optim.lr_scheduler.MultiStepLR`` stepped once after every update
gives that sequence when it is handed the folded boundaries.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def lr_boundaries(milestones: Sequence[int], episodes_per_step: int) -> List[int]:
    """The distinct updates at which the rate decays, ascending."""
    return sorted({max(1, int(m) // episodes_per_step) for m in milestones})


def make_optimizer(name: str, params, base_lr: float, milestones: Sequence[int],
                   gamma: float, episodes_per_step: int
                   ) -> Tuple[torch.optim.Optimizer,
                              torch.optim.lr_scheduler.MultiStepLR]:
    """(optimizer, scheduler): plain SGD without momentum (``optax.sgd``) or
    Adam with optax's defaults (``optax.adam``), and the MultiStepLR that
    the caller steps once after every update."""
    if name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr)
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, lr_boundaries(milestones, episodes_per_step), gamma)
    return opt, sched

"""The checked steps of a training cell: what set-up runs before the window
and the calibration repeats seed after seed, in one place, so that the
limits are set from the code that a run checks with.

:func:`build` makes the program's train state and step once;
:func:`checked_steps` lays a seed's weights over the state, makes the pool
of batches on the card and drives the first ``check_steps`` steps through
the step the window calls, on pool batches that all differ. It keeps each
step's loss, the first gradient and the parameters after the last step (on
the host), and holds every step to the SGD rule: the parameters after a
step are those before it less the learning rate times the gradient that the
step left, ``update_gap`` being the norm of what the state departs from
that, over the norm of the update, at the worst step. A step that leaves
its state unchanged, skips a step or applies the update at another scale
reads 1, 1 or |scale − 1|.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from portbench import families, program
from portbench.data import load_


@dataclass
class Built:
    fam: Any                       # the family module
    cfg: Any                       # the program's Config
    state: Any
    step: Any
    modules: Dict[str, Optional[torch.nn.Module]] = field(default_factory=dict)
    shapes: Dict[str, List] = field(default_factory=dict)


def build(cell, seed: int, device, dp=None, cfg=None) -> Built:
    """The program's train state and step of ``cell`` (``cfg``: a Config
    other than the cell's, as the calibration's fp32 witness takes)."""
    fam = families.load(cell)
    cfg = program.config(cell.config, seed) if cfg is None else cfg
    program.set_fp32_math()
    state = fam.train_state(cfg, device)
    modules = {"model": state.model, "teacher": state.teacher}
    return Built(fam, cfg, state, fam.train_step(cfg, dp), modules, families.shapes(modules))


def reseed(state, seed: int) -> None:
    """The dropout generators as the program seeds them for ``seed``
    (seed + 2, the teacher's seed + 3): a state built once and reused for
    another seed."""
    state.generator.manual_seed(seed + 2)
    if state.teacher_generator is not None:
        state.teacher_generator.manual_seed(seed + 3)


def update_gap(model: torch.nn.Module, before: Dict[str, torch.Tensor], lr: float) -> float:
    """‖parameters − (before − lr·grad)‖ / ‖lr·grad‖ over every leaf as one
    vector, the expected step taken in fp32 as SGD takes it; a leaf without
    a gradient is expected to stay."""
    r2 = u2 = None
    with torch.no_grad():
        for n, p in model.named_parameters():
            prev = before[n].to(p.device, non_blocking=True)
            want = prev if p.grad is None else prev.add(p.grad, alpha=-lr)
            r = torch.linalg.vector_norm((p.detach() - want).float()).double() ** 2
            r2 = r if r2 is None else r2 + r
            if p.grad is not None:
                u = (lr * torch.linalg.vector_norm(p.grad.float()).double()) ** 2
                u2 = u if u2 is None else u2 + u
            del prev, want
    r2, u2 = float(r2), (0.0 if u2 is None else float(u2))
    if u2 == 0.0:
        return 1.0 if r2 == 0.0 else math.inf
    return math.sqrt(r2 / u2)


def host_copy(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


class Snapshot:
    """The parameters before a step, in host memory allocated once and
    reused (pinned on a card, so that the copies are quick)."""

    def __init__(self, model: torch.nn.Module):
        self.host = {n: torch.empty(p.shape, dtype=p.dtype, pin_memory=p.is_cuda)
                     for n, p in model.named_parameters()}

    def take(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        for n, p in model.named_parameters():
            self.host[n].copy_(p.detach(), non_blocking=True)
        return self.host


def checked_steps(cell, b: Built, seed: int, device, lo: int = 0, hi: Optional[int] = None,
                  fresh: bool = True) -> Dict:
    """Lay ``seed``'s weights over ``b.state``, make the pool (episodes
    [lo, hi) of each batch: a data-parallel rank's share) and run the
    checked steps. ``fresh`` False: the state was built for another seed,
    so its dropout generators are seeded anew. Returns {'losses',
    'grad1', 'params', 'update_gap': (gap, where), 'pool'}."""
    w = families.draw(b.shapes, seed, device)
    for k in b.shapes:
        load_(b.modules[k], w[k])
    del w
    if not fresh:
        reseed(b.state, seed)
    hi = b.cfg.train.tasks_per_batch if hi is None else hi
    pool = [program.episode_batch(b.fam.episodes(cell.config, seed, i, lo, hi, device))
            for i in range(cell.mix["pool"])]
    lr = b.fam.learning_rate(cell.config)
    model = b.state.model
    losses, grad1, gaps = [], None, []
    snap = Snapshot(model)
    for k in range(cell.mix["check_steps"]):
        before = snap.take(model)
        m = b.step(b.state, pool[k % len(pool)])
        losses.append(float(program.step_loss(m)))
        if grad1 is None:
            grad1 = {n: p.grad.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters() if p.grad is not None}
        gaps.append(update_gap(model, before, lr))
        del m
    del snap, before
    worst = max(range(len(gaps)), key=lambda i: gaps[i])
    return {"losses": losses, "grad1": grad1, "params": host_copy(model),
            "update_gap": (gaps[worst], f"step {worst + 1} of {gaps}"), "pool": pool}


def reference_inputs(cell, fam, shapes: Dict[str, List], seed: int, device):
    """The weights and the checked steps' whole batches, made anew from the
    seed for the reference."""
    e = families.sizes(cell.config)["tasks_per_batch"]
    w = families.draw(shapes, seed, device)
    batches = [fam.episodes(cell.config, seed, i % cell.mix["pool"], 0, e, device)
               for i in range(cell.mix["check_steps"])]
    return w, batches

"""Checkpoints in the reference's ``.pt`` layout (port of
``litemkd_tpu/train/checkpoint.py``; Orbax needs JAX, so the port writes
what the reference's ``torch.save`` wrote, ``trainwandb.py:172-180``).

One file per save, ``checkpoint_<episodes>.pt`` in the run's directory:
``{"iteration": episodes seen, "model_state_dict": the trained model (the
student, or the MFM teacher) in the reference key layout, "optimizer",
"scheduler"}`` plus what a resume needs (``step``, ``episodes_seen``, the
state of the dropout generator, and for a student run
``teacher_state_dict`` and the teacher's generator). The newest
``max_to_keep`` files are kept. A run over a model axis writes the same
file from rank 0, its shards gathered. The run's ``config.json`` lies beside them,
so ``litemkd_torch.cli.test -m <file>`` (or ``train_teacher --test_only
-m <file>``) reads its geometry from there. A directory restores on either
device type: a generator state saved on another one (a CUDA generator's is
16 bytes, a CPU generator's 5,056) cannot be set, so that generator is
reseeded from the run's seed and step instead, and the restore says so.
"""
from __future__ import annotations

import logging
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ..parallel.tensor_parallel import (full_optimizer_state_dict,
                                        full_state_dict,
                                        shard_optimizer_state_dict,
                                        shard_state_dict)
from .steps import TrainState, dropout_seeds

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")
_log = logging.getLogger(__name__)


def _cpu(sd: dict) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _saved(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      (_NAME.match(f) for f in os.listdir(self.directory)) if m)

    def path(self, episodes: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{episodes}.pt")

    def latest_step(self) -> Optional[int]:
        """Episodes seen at the newest checkpoint, or None."""
        saved = self._saved()
        return saved[-1] if saved else None

    def save(self, state: TrainState, write: bool = True) -> Optional[str]:
        """Write ``state`` (where ``write``; returns the path). A state cut
        over a model axis is gathered first, in the one-process layout:
        every rank of its model group must call this, and one writes."""
        axis = getattr(state.model, "tp_axis", None)
        if not write and axis is None:
            return None
        payload = {
            "iteration": state.episodes_seen,
            "model_state_dict": _cpu(full_state_dict(state.model)),
            "optimizer": full_optimizer_state_dict(state.optimizer, axis),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
            "episodes_seen": state.episodes_seen,
            "generator": state.generator.get_state(),
        }
        if state.teacher is not None:
            payload["teacher_generator"] = state.teacher_generator.get_state()
            payload["teacher_state_dict"] = _cpu(full_state_dict(state.teacher))
        if not write:
            return None
        path = self.path(state.episodes_seen)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)   # a reader never sees a half-written file
        for old in self._saved()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState, seed: int) -> TrainState:
        """Load the newest checkpoint into ``state`` (in place). ``seed`` is
        the run's ``cfg.train.seed``, from which a generator saved on
        another device type is reseeded. A state cut over a model axis
        takes its shard of the one-process checkpoint."""
        episodes = self.latest_step()
        if episodes is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        ckpt = torch.load(self.path(episodes), map_location=device,
                          weights_only=True)
        axis = getattr(state.model, "tp_axis", None)
        state.model.load_state_dict(
            shard_state_dict(state.model, ckpt["model_state_dict"]), strict=True)
        state.optimizer.load_state_dict(
            shard_optimizer_state_dict(state.optimizer, ckpt["optimizer"], axis))
        state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = int(ckpt["step"])
        state.episodes_seen = int(ckpt["episodes_seen"])
        model_seed, teacher_seed = dropout_seeds(seed)
        _set_generator(state.generator, ckpt["generator"], model_seed, state.step)
        if state.teacher is not None:
            _set_generator(state.teacher_generator, ckpt["teacher_generator"],
                           teacher_seed, state.step)
            state.teacher.load_state_dict(
                shard_state_dict(state.teacher, ckpt["teacher_state_dict"]),
                strict=True)
        return state


def _set_generator(generator: torch.Generator, saved: torch.Tensor,
                   seed: int, step: int) -> None:
    """Set ``generator`` to its saved state; where that state comes from
    another device type, seed it from (``seed``, ``step``) instead."""
    saved = saved.cpu()
    if saved.numel() == generator.get_state().numel():
        generator.set_state(saved)
        return
    generator.manual_seed(int(np.random.SeedSequence((seed, step))
                              .generate_state(1, np.uint64)[0]))
    _log.warning("checkpoint generator state of %d bytes does not fit this "
                 "%s generator; reseeded it from seed %d and step %d",
                 saved.numel(), generator.device.type, seed, step)


def verify_checkpoint_dir(directory: str, resume: bool) -> None:
    """Reference semantics (options.py:106-123): a fresh run needs a fresh
    directory, a resume an existing one. Raises instead of exiting."""
    if resume:
        if not os.path.exists(directory):
            raise FileNotFoundError(
                f"can't resume: checkpoint dir {directory} does not exist")
    else:
        if os.path.exists(directory) and os.listdir(directory):
            raise FileExistsError(
                f"checkpoint dir {directory} already exists; pass resume or a "
                f"fresh directory")
        os.makedirs(directory, exist_ok=True)

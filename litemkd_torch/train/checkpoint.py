"""Checkpoints in the reference's ``.pt`` layout (port of
``litemkd_tpu/train/checkpoint.py``; Orbax needs JAX, so the port writes
what the reference's ``torch.save`` wrote, ``trainwandb.py:172-180``).

One file per save, ``checkpoint_<episodes>.pt`` in the run's directory:
``{"iteration": episodes seen, "model_state_dict": the student in the
reference key layout, "optimizer", "scheduler"}`` plus what a resume needs
(``step``, ``episodes_seen``, ``teacher_state_dict``, and the states of the
dropout generators). The newest ``max_to_keep`` files are kept. The run's
``config.json`` lies beside them, so ``litemkd_torch.cli.test -m
<file>`` reads its geometry from there.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from .steps import TrainState

_NAME = re.compile(r"^checkpoint_(\d+)\.pt$")


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

    def save(self, state: TrainState) -> str:
        payload = {
            "iteration": state.episodes_seen,
            "model_state_dict": _cpu(state.model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": state.step,
            "episodes_seen": state.episodes_seen,
            "generator": state.generator.get_state(),
            "teacher_generator": state.teacher_generator.get_state(),
            "teacher_state_dict": _cpu(state.teacher.state_dict()),
        }
        path = self.path(state.episodes_seen)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)   # a reader never sees a half-written file
        for old in self._saved()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, state: TrainState) -> TrainState:
        """Load the newest checkpoint into ``state`` (in place)."""
        episodes = self.latest_step()
        if episodes is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        ckpt = torch.load(self.path(episodes), map_location=device,
                          weights_only=True)
        state.model.load_state_dict(ckpt["model_state_dict"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = int(ckpt["step"])
        state.episodes_seen = int(ckpt["episodes_seen"])
        state.generator.set_state(ckpt["generator"].cpu())
        state.teacher_generator.set_state(ckpt["teacher_generator"].cpu())
        state.teacher.load_state_dict(ckpt["teacher_state_dict"], strict=True)
        return state


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

"""Episode batches and the eval step (port of
``litemkd_tpu/train/steps.py:31-47, 211-230``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..config import Config
from ..distill import merge_logits
from ..utils.metrics import per_episode_accuracy


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


def make_eval_step(cfg: Config) -> Callable:
    """Eval step: ``eval_step(model, batch) → (E,)`` per-episode accuracies
    of the merged branch logits, computed on the batch's device."""

    def eval_step(model: torch.nn.Module, batch: EpisodeBatch) -> torch.Tensor:
        with torch.inference_mode():
            out = model(batch.support_clips, batch.support_labels,
                        batch.query_clips)
            merged = merge_logits(cfg.distill.name, out["logits"])
            return per_episode_accuracy(merged, batch.query_labels)

    return eval_step

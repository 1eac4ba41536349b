"""Episodic metrics (port of ``litemkd_tpu/utils/metrics.py:19-78``): the
per-episode accuracy, the map of episode-local predictions to real class
ids for the per-task confusion analysis, and the reference's 95%-CI
protocol (mean·100 ± 196·std/√n)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def per_episode_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(E, Q, way) × (E, Q) → (E,) per-episode accuracies. Ties go to the
    first maximal class, as with ``jnp.argmax``."""
    return (logits.argmax(dim=-1) == labels).float().mean(dim=-1)


def task_confusion(logits: torch.Tensor,
                   batch_class_list: torch.Tensor) -> torch.Tensor:
    """Episode-local predictions → REAL class ids (``utils.py:123-127``):
    (Q, way) logits with a (way,) class list, or (E, Q, way) with (E, way),
    → the real class id of each query's argmax (the reference logsumexps
    over a sample axis of size 1 first, which changes nothing)."""
    return real_class_preds(logits.argmax(dim=-1), batch_class_list)


def real_class_preds(preds: torch.Tensor,
                     batch_class_list: torch.Tensor) -> torch.Tensor:
    """Episode-local argmax predictions (..., Q) → real class ids through
    the episode's class list (..., way): the gather half of
    :func:`task_confusion`."""
    classes = torch.as_tensor(batch_class_list)
    return torch.gather(classes, -1, torch.as_tensor(preds).long())


def confidence_interval(accuracies: np.ndarray) -> Dict[str, float]:
    """The reference's eval statistic: accuracy ×100 with 196·std/√n CI."""
    acc = np.asarray(accuracies, dtype=np.float64)
    n = len(acc)
    if n == 0:
        return {"accuracy": float("nan"), "confidence": float("nan"),
                "n_tasks": 0}
    mean = float(acc.mean() * 100.0)
    ci = float(196.0 * acc.std() / np.sqrt(n))
    return {"accuracy": mean, "confidence": ci, "n_tasks": n}


class TestAccuracies:
    """Accumulates per-episode accuracies and renders the reference-style
    summary line."""

    def __init__(self) -> None:
        self._acc: List[float] = []

    def add(self, episode_accuracy: float) -> None:
        self._acc.append(float(episode_accuracy))

    def extend(self, accs) -> None:
        self._acc.extend(float(a) for a in np.asarray(accs).ravel())

    def summary(self) -> Dict[str, float]:
        return confidence_interval(np.asarray(self._acc))

    def __len__(self) -> int:
        return len(self._acc)

    def render(self, dataset: str = "") -> str:
        s = self.summary()
        return f"{dataset}: {s['accuracy']:.1f}+/-{s['confidence']:.1f}"

"""Real-class confusion analysis over per-task eval logs (port of
``litemkd_tpu/tools/confusion.py:1-89``).

``litemkd_torch.cli.test --per_task_log`` writes one JSON record per task
with ``real_labels``/``real_preds`` (episode-local argmaxes mapped through
the episode's class list); this module aggregates those records into a
real-class confusion matrix, per-class accuracy, the most-confused class
pairs, a CSV file and, with matplotlib, a PNG. It is the reference's
commented-out bad-case analysis (``test.py:115-316``, fed by ``utils.py:123``
``task_confusion``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np


def read_task_log(path: str) -> List[dict]:
    """The records of a per-task log, one JSON object a line."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def confusion_from_records(records: Sequence[dict]) -> Tuple[np.ndarray, List[int]]:
    """Aggregate per-task ``real_labels``/``real_preds`` into a (C, C) count
    matrix ``m[true, pred]`` over the sorted union of real class ids seen."""
    ids = sorted({int(c) for r in records
                  for c in list(r["real_labels"]) + list(r["real_preds"])})
    pos = {c: i for i, c in enumerate(ids)}
    m = np.zeros((len(ids), len(ids)), np.int64)
    for r in records:
        for t, p in zip(r["real_labels"], r["real_preds"]):
            m[pos[int(t)], pos[int(p)]] += 1
    return m, ids


def per_class_accuracy(m: np.ndarray) -> np.ndarray:
    """Row-wise share of correct predictions; NaN for a class never seen as
    a true label."""
    totals = m.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(totals > 0, np.diag(m) / np.maximum(totals, 1), np.nan)


def most_confused(m: np.ndarray, ids: Sequence[int],
                  top: int = 10) -> List[Tuple[int, int, int]]:
    """Off-diagonal (true, predicted, count) triples, most frequent first."""
    out = [(ids[i], ids[j], int(m[i, j]))
           for i in range(len(ids)) for j in range(len(ids))
           if i != j and m[i, j] > 0]
    out.sort(key=lambda t: -t[2])
    return out[:top]


def write_csv(m: np.ndarray, ids: Sequence[int], path: str,
              class_names: Dict[int, str] | None = None) -> None:
    """The matrix as CSV: a ``true\\pred`` header row of class names (or
    ids), then one row per true class."""
    name = (lambda c: class_names.get(c, str(c))) if class_names else str
    with open(path, "w") as f:
        f.write("true\\pred," + ",".join(name(c) for c in ids) + "\n")
        for i, c in enumerate(ids):
            f.write(name(c) + "," + ",".join(str(int(x)) for x in m[i]) + "\n")


def render_png(m: np.ndarray, ids: Sequence[int], path: str) -> str:
    """The row-normalised matrix as a PNG heat map (matplotlib is imported
    here, only when a figure is asked for); returns ``path``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    norm = m / np.maximum(m.sum(axis=1, keepdims=True), 1)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(norm, cmap="viridis", vmin=0.0, vmax=1.0)
    ax.set_xlabel("predicted class id")
    ax.set_ylabel("true class id")
    step = max(1, len(ids) // 20)
    ax.set_xticks(range(0, len(ids), step),
                  [str(c) for c in ids[::step]], rotation=90, fontsize=6)
    ax.set_yticks(range(0, len(ids), step),
                  [str(c) for c in ids[::step]], fontsize=6)
    fig.colorbar(im, ax=ax, label="row-normalized frequency")
    fig.tight_layout()
    fig.savefig(path, dpi=160)
    plt.close(fig)
    return path

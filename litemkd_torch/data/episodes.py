"""Episode specs (the port's copy of ``EpisodeSpec`` and
``draw_episode_spec``, ``litemkd_tpu/data/episodes.py:36-66``): an episode
is ``way`` classes drawn from a split index and ``shot + queries`` distinct
videos of each. Fixed-episode replay is not ported yet."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .splits import SplitIndex


class EpisodeSpec:
    """A fully-determined episode: class ids + per-class video indices."""

    __slots__ = ("classes", "support_idx", "query_idx")

    def __init__(self, classes: Sequence[int],
                 support_idx: Sequence[Sequence[int]],
                 query_idx: Sequence[Sequence[int]]):
        self.classes = list(classes)
        self.support_idx = [list(s) for s in support_idx]
        self.query_idx = [list(q) for q in query_idx]


def draw_episode_spec(index: SplitIndex, way: int, shot: int, queries: int,
                      rng: np.random.Generator) -> EpisodeSpec:
    """``way`` distinct classes of ``index``, then ``shot + queries``
    distinct videos of each class, in the JAX package's draw order. Every
    class needs at least ``shot + queries`` videos."""
    classes = [int(c) for c in
               rng.choice(np.asarray(index.classes()), size=way, replace=False)]
    support_idx, query_idx = [], []
    for c in classes:
        n = index.n_videos(c)
        picks = rng.choice(n, size=shot + queries, replace=False)
        support_idx.append([int(i) for i in picks[:shot]])
        query_idx.append([int(i) for i in picks[shot:]])
    return EpisodeSpec(classes, support_idx, query_idx)

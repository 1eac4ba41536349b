"""Multi-modal feature episodes, the MFM fusion teacher's data source (port
of ``MultiModalEpisodeSampler``, ``litemkd_tpu/data/multimodal.py:20-59``;
the reference's ``MultiVideoDataset``, ``multi_video_reader.py:285-378``).

Support and query sets are dicts of per-modality (T, D) feature arrays keyed
by modality name, zero-filled where a modality is missing for a video. The
numpy draws are the JAX package's, in the same order, so one seed gives
equal batches in both packages.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..train.steps import EpisodeBatch
from .episodes import EpisodeSpec, draw_episode_spec
from .features import MultiModalFeatureStore


class MultiModalEpisodeSampler:
    def __init__(self, cfg: Config, store: MultiModalFeatureStore):
        self.cfg = cfg
        self.store = store

    def sample_batch(self, rng: np.random.Generator, n_episodes: int,
                     train: bool = True,
                     specs: Optional[List[EpisodeSpec]] = None) -> EpisodeBatch:
        """``n_episodes`` episodes (or the given ``specs``) as numpy arrays:
        clips are ``{modality: (E, N, T, D)}`` dicts, labels (E, N) int32."""
        ep = self.cfg.episode
        queries = ep.query_per_class if train else ep.query_per_class_test
        index = self.store.split(train)
        if specs is None:
            specs = [draw_episode_spec(index, ep.way, ep.shot, queries, rng)
                     for _ in range(n_episodes)]
        sup_f: Dict[str, list] = {m: [] for m in self.store.modalities}
        qry_f: Dict[str, list] = {m: [] for m in self.store.modalities}
        sup_l, qry_l = [], []
        for spec in specs:
            s_items, q_items = [], []
            for label, (c, s_idx, q_idx) in enumerate(
                    zip(spec.classes, spec.support_idx, spec.query_idx)):
                s_items += [(index.get(c, i), label) for i in s_idx]
                q_items += [(index.get(c, i), label) for i in q_idx]
            rng.shuffle(s_items)
            rng.shuffle(q_items)
            for m in self.store.modalities:
                sup_f[m].append(np.stack(
                    [self.store.load(r, m, train) for r, _ in s_items]))
                qry_f[m].append(np.stack(
                    [self.store.load(r, m, train) for r, _ in q_items]))
            sup_l.append(np.asarray([l for _, l in s_items], np.int32))
            qry_l.append(np.asarray([l for _, l in q_items], np.int32))
        return EpisodeBatch(
            support_clips={m: np.stack(v) for m, v in sup_f.items()},
            support_labels=np.stack(sup_l),
            query_clips={m: np.stack(v) for m, v in qry_f.items()},
            query_labels=np.stack(qry_l),
        )

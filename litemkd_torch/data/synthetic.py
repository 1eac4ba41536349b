"""Synthetic episodic dataset (port of ``litemkd_tpu/data/synthetic.py:35-172``).

Class-structured episodes (frames drawn around per-class visual prototypes,
teacher features around per-class feature prototypes). The numpy draws are
the JAX package's, in the same order, so one seed gives equal batches in
both packages. Fixed-episode replay (``specs``) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..train.steps import EpisodeBatch


class SyntheticEpisodeSource:
    """Stateless-per-call episode sampler over ``n_classes`` synthetic classes."""

    def __init__(self, cfg: Config, n_classes: int = 12, seed: int = 0,
                 noise: float = 0.3, with_teacher_feats: bool = True):
        self.cfg = cfg
        self.n_classes = n_classes
        self.noise = noise
        self.with_teacher = with_teacher_feats
        ep, m = cfg.episode, cfg.model
        rng = np.random.default_rng(seed)
        self.frame_protos = rng.normal(
            size=(n_classes, ep.seq_len, ep.img_size, ep.img_size, 3)
        ).astype(np.float32)
        self.feat_protos = rng.normal(
            size=(n_classes, ep.seq_len, m.trans_linear_in_dim)
        ).astype(np.float32)

    def sample_batch(self, rng: np.random.Generator, n_episodes: int,
                     train: bool = True) -> EpisodeBatch:
        """Draw ``n_episodes`` episodes as numpy arrays."""
        ep = self.cfg.episode
        qpc = ep.query_per_class if train else ep.query_per_class_test
        s_clips, s_labels, q_clips, q_labels = [], [], [], []
        s_feats, q_feats = [], []
        for _ in range(n_episodes):
            classes = rng.choice(self.n_classes, size=ep.way, replace=False)
            sl = rng.permutation(np.repeat(np.arange(ep.way), ep.shot))
            ql = rng.permutation(np.repeat(np.arange(ep.way), qpc))
            s_clips.append(self._draw_frames(rng, classes[sl]))
            q_clips.append(self._draw_frames(rng, classes[ql]))
            if self.with_teacher:
                s_feats.append(self._draw_feats(rng, classes[sl]))
                q_feats.append(self._draw_feats(rng, classes[ql]))
            s_labels.append(sl)
            q_labels.append(ql)
        kw = {}
        if self.with_teacher:
            kw = dict(support_feats=np.stack(s_feats),
                      query_feats=np.stack(q_feats))
        return EpisodeBatch(
            support_clips=np.stack(s_clips),
            support_labels=np.stack(s_labels).astype(np.int32),
            query_clips=np.stack(q_clips),
            query_labels=np.stack(q_labels).astype(np.int32),
            **kw,
        )

    def _draw_frames(self, rng, class_ids):
        base = self.frame_protos[class_ids]
        x = base + self.noise * rng.normal(size=base.shape)
        # quantize to uint8 pixels like the real pipeline ships
        return np.clip((x * 40 + 128), 0, 255).astype(np.uint8)

    def _draw_feats(self, rng, class_ids):
        base = self.feat_protos[class_ids]
        return (base + self.noise * rng.normal(size=base.shape)).astype(np.float32)

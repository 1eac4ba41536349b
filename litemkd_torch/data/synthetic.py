"""Synthetic episodic dataset (port of ``litemkd_tpu/data/synthetic.py:20-172``).

Class-structured episodes (frames drawn around per-class visual prototypes,
teacher features around per-class feature prototypes). The numpy draws are
the JAX package's, in the same order, so one seed gives equal batches in
both packages. Fixed episodes (``specs``) replay by content: a synthetic
(class, video index) always draws the same clip and features.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..train.steps import EpisodeBatch
from .splits import SplitIndex, VideoRecord


def _spec_video_ids(labels, per_class_idx):
    """Map a shuffled label vector to within-class video ids: the k-th
    occurrence of label ``w`` takes ``per_class_idx[w][k]``."""
    counters = [0] * len(per_class_idx)
    out = []
    for w in labels:
        idxs = per_class_idx[int(w)]
        if counters[int(w)] >= len(idxs):
            raise ValueError("fixed episode has fewer videos for class "
                             f"{int(w)} than this config samples")
        out.append(int(idxs[counters[int(w)]]))
        counters[int(w)] += 1
    return out


class SyntheticEpisodeSource:
    """Stateless-per-call episode sampler over ``n_classes`` synthetic classes."""

    # nominal videos per class of :meth:`split`: content is keyed on (class,
    # video index), so any count of at least shot + queries works, and the
    # same count must build and invert the reference schema's global
    # video_idx offsets
    NOMINAL_VIDEOS_PER_CLASS = 32

    def __init__(self, cfg: Config, n_classes: int = 12, seed: int = 0,
                 noise: float = 0.3, with_teacher_feats: bool = True):
        self.cfg = cfg
        self.n_classes = n_classes
        self.noise = noise
        self.with_teacher_feats = with_teacher_feats
        self._content_seed = seed   # keys the replayable per-video draws
        ep, m = cfg.episode, cfg.model
        rng = np.random.default_rng(seed)
        self.frame_protos = rng.normal(
            size=(n_classes, ep.seq_len, ep.img_size, ep.img_size, 3)
        ).astype(np.float32)
        self.feat_protos = rng.normal(
            size=(n_classes, ep.seq_len, m.trans_linear_in_dim)
        ).astype(np.float32)

    def split(self, train: bool = False) -> SplitIndex:
        """A nominal index, so that fixed-episode files (the port's and the
        reference's schema) are written and replayed against synthetic data
        as against a real tree."""
        index = SplitIndex()
        for c in range(self.n_classes):
            for v in range(self.NOMINAL_VIDEOS_PER_CLASS):
                index.add(VideoRecord(class_id=c,
                                      video_id=f"synthetic_{c}_{v}"))
        return index

    def sample_batch(self, rng: np.random.Generator, n_episodes: int,
                     train: bool = True, specs=None) -> EpisodeBatch:
        """Draw ``n_episodes`` episodes as numpy arrays; with ``specs`` (a
        list of ``EpisodeSpec``) replay those episodes' content."""
        ep = self.cfg.episode
        qpc = ep.query_per_class if train else ep.query_per_class_test
        s_clips, s_labels, q_clips, q_labels = [], [], [], []
        s_feats, q_feats = [], []
        for e in range(n_episodes):
            if specs is not None:
                spec = specs[e]
                classes = np.asarray(spec.classes)
                if classes.max() >= self.n_classes:
                    raise ValueError(
                        f"fixed episode references class {int(classes.max())} "
                        f"but the synthetic source has {self.n_classes}")
            else:
                classes = rng.choice(self.n_classes, size=ep.way, replace=False)
            sl = rng.permutation(np.repeat(np.arange(ep.way), ep.shot))
            ql = rng.permutation(np.repeat(np.arange(ep.way), qpc))
            if specs is not None:
                s_vid = _spec_video_ids(sl, spec.support_idx)
                q_vid = _spec_video_ids(ql, spec.query_idx)
                s_clips.append(self._replay_frames(classes[sl], s_vid))
                q_clips.append(self._replay_frames(classes[ql], q_vid))
                if self.with_teacher_feats:
                    s_feats.append(self._replay_feats(classes[sl], s_vid))
                    q_feats.append(self._replay_feats(classes[ql], q_vid))
            else:
                s_clips.append(self._draw_frames(rng, classes[sl]))
                q_clips.append(self._draw_frames(rng, classes[ql]))
                if self.with_teacher_feats:
                    s_feats.append(self._draw_feats(rng, classes[sl]))
                    q_feats.append(self._draw_feats(rng, classes[ql]))
            s_labels.append(sl)
            q_labels.append(ql)
        kw = {}
        if self.with_teacher_feats:
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

    def _replay_frames(self, class_ids, video_ids):
        out = []
        for c, v in zip(class_ids, video_ids):
            r = np.random.default_rng((self._content_seed, 0, int(c), int(v)))
            x = self.frame_protos[c] + self.noise * r.normal(
                size=self.frame_protos[c].shape)
            out.append(np.clip((x * 40 + 128), 0, 255).astype(np.uint8))
        return np.stack(out)

    def _replay_feats(self, class_ids, video_ids):
        out = []
        for c, v in zip(class_ids, video_ids):
            r = np.random.default_rng((self._content_seed, 1, int(c), int(v)))
            out.append((self.feat_protos[c] + self.noise * r.normal(
                size=self.feat_protos[c].shape)).astype(np.float32))
        return np.stack(out)

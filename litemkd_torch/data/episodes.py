"""Episode sampling (port of ``litemkd_tpu/data/episodes.py``): the host's
assembly of N-way K-shot tasks from a frame tree and the fused teacher
features, and fixed-episode replay.

An episode is ``way`` classes drawn from a split index and ``shot +
queries`` distinct videos of each (:func:`draw_episode_spec`). The sampler
loads each video's clip and its teacher feature, shuffles support and query
apart, and stacks whole episode batches. The numpy draws are the JAX
package's, in the same order, so one seed gives the same batch in both
packages. Fixed episodes replay from the port's JSON files or from the
reference's ``fixed_test`` JSON/YAML schema.
"""
from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..train.steps import EpisodeBatch
from .features import FeatureStore
from .splits import SplitIndex
from .video import VideoStore


class EpisodeMeta(NamedTuple):
    """Real-class bookkeeping of an episode batch (the reference's
    ``batch_class_list`` / ``real_target_labels``, ``test.py:352-353``):
    ``classes[e, w]`` is the real class id behind episode label ``w``,
    ``real_query_labels[e, q]`` the real class of each query video."""

    classes: np.ndarray            # (E, way) int32
    real_query_labels: np.ndarray  # (E, Q) int32


class EpisodeSpec:
    """A fully-determined episode: class ids + per-class video indices."""

    __slots__ = ("classes", "support_idx", "query_idx")

    def __init__(self, classes: Sequence[int],
                 support_idx: Sequence[Sequence[int]],
                 query_idx: Sequence[Sequence[int]]):
        self.classes = list(classes)
        self.support_idx = [list(s) for s in support_idx]
        self.query_idx = [list(q) for q in query_idx]

    def to_json(self) -> dict:
        return {"classes": self.classes, "support": self.support_idx,
                "query": self.query_idx}

    @staticmethod
    def from_json(d: dict) -> "EpisodeSpec":
        return EpisodeSpec(d["classes"], d["support"], d["query"])


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


def save_fixed_episodes(specs: List[EpisodeSpec], path: str) -> None:
    with open(path, "w") as f:
        json.dump([s.to_json() for s in specs], f)


def load_fixed_episodes(path: str) -> List[EpisodeSpec]:
    with open(path) as f:
        return [EpisodeSpec.from_json(d) for d in json.load(f)]


def _class_offsets(index: SplitIndex) -> Dict[int, int]:
    """Each class's first position in the class-major sorted video scan."""
    offsets, off = {}, 0
    for c in index.classes():
        offsets[int(c)] = off
        off += index.n_videos(c)
    return offsets


def save_reference_fixed_episodes(specs: List[EpisodeSpec], index: SplitIndex,
                                  path: str) -> None:
    """Write episodes in the reference's fixed_test schema
    (``splits/gen_fixed_split.py:167-194``: per-episode support/query entry
    lists with ``class_bc`` and a global ``video_idx``), as YAML when the
    path ends .yaml/.yml (the form the reference replays) and JSON
    otherwise. The exact inverse of :func:`load_reference_fixed_episodes`."""
    offsets = _class_offsets(index)
    data = {}
    for e, spec in enumerate(specs):
        sup, qry = [], []
        for c, s_idx, q_idx in zip(spec.classes, spec.support_idx,
                                   spec.query_idx):
            for j in s_idx:
                sup.append({"id": len(sup), "class_bc": int(c),
                            "video_idx": offsets[int(c)] + int(j)})
            for j in q_idx:
                qry.append({"id": len(qry), "class_bc": int(c),
                            "video_idx": offsets[int(c)] + int(j)})
        data[e] = {"support": sup, "query": qry}
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml
            yaml.safe_dump(data, f)
        else:
            json.dump(data, f)


def load_reference_fixed_episodes(path: str,
                                  index: SplitIndex) -> List[EpisodeSpec]:
    """Read the reference's ``fixed_test.json|yaml`` episode files
    (``splits/gen_fixed_split.py:167-194``): a dict of episodes whose
    support/query entries carry ``class_bc`` (class id) and ``video_idx``
    (the global index into the class-major sorted video scan), converted to
    per-class indices against ``index``, which sorts its scan the same way."""
    if path.endswith((".yaml", ".yml")):
        import yaml
        with open(path) as f:
            data = yaml.safe_load(f)
    else:
        with open(path) as f:
            data = json.load(f)
    offsets = _class_offsets(index)
    specs = []
    for k in sorted(data, key=lambda x: int(x)):
        ep = data[k]
        classes: List[int] = []
        sup: Dict[int, List[int]] = {}
        qry: Dict[int, List[int]] = {}
        for part, store in (("support", sup), ("query", qry)):
            for d in ep[part]:
                c = int(d["class_bc"])
                if c not in classes and part == "support":
                    classes.append(c)
                if c not in offsets:
                    raise ValueError(
                        f"episode {k}: class_bc {c} does not exist in the "
                        f"local {len(offsets)}-class split — the fixed file "
                        "was built against a different dataset/split")
                idx = int(d["video_idx"]) - offsets[c]
                if not 0 <= idx < index.n_videos(c):
                    raise ValueError(
                        f"episode {k}: video_idx {d['video_idx']} maps to "
                        f"within-class index {idx} outside class {c}'s "
                        f"{index.n_videos(c)} videos — the local video scan "
                        "diverges from the one the fixed file was built from")
                store.setdefault(c, []).append(idx)
        orphans = set(qry) - set(classes)
        if orphans:
            raise ValueError(
                f"episode {k}: query entries for classes {sorted(orphans)} "
                "that have no support entries — dropping them would silently "
                "change the episode the file specifies")
        specs.append(EpisodeSpec(classes, [sup[c] for c in classes],
                                 [qry.get(c, []) for c in classes]))
    return specs


class EpisodeSampler:
    """Episode batches from a VideoStore (and a FeatureStore of fused
    teacher features, paired with each video by class name and video id).

    The clips of one episode load in a thread pool of ``num_workers``
    threads (0: on the calling thread); the C++ decoder and PIL both
    release the GIL while they decode."""

    def __init__(self, cfg: Config, video_store: Optional[VideoStore],
                 feature_store: Optional[FeatureStore] = None,
                 num_workers: int = 4):
        assert video_store is not None or feature_store is not None
        self.cfg = cfg
        self.videos = video_store
        self.features = feature_store
        self.pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers else None
        # (train, class NAME, video_id) → feature record: the two trees are
        # scanned apart, and a class folder missing from one renumbers its
        # later classes
        self._feat_lookup: Dict[tuple, object] = {}
        if feature_store is not None and video_store is not None:
            for train in (True, False):
                idx = feature_store.split(train)
                for cid in idx.classes():
                    cname = feature_store.class_names[cid]
                    for cand in idx.videos_for_class(cid):
                        self._feat_lookup[(train, cname, cand.video_id)] = cand

    def _index(self, train: bool) -> SplitIndex:
        store = self.videos if self.videos is not None else self.features
        return store.split(train)

    def _load_one(self, rec, train: bool, seed: int, support: bool = True):
        rng = np.random.default_rng(seed)
        clip = feats = None
        if self.videos is not None:
            view = self._pick_view(support, rng)
            clip = (self.videos.load(rec, train, rng) if view is None
                    else self.videos.load_view(rec, view, train, rng))
        if self.features is not None:
            frec = self._feature_record(rec, train)
            if frec is not None:
                feats = self.features.load(frec)
            elif self.features.strict:
                # the reference crashes on a missing feature.npy; training
                # against zero-filled teacher features would fail silently
                cname = self.videos.class_names[rec.class_id]
                raise FileNotFoundError(
                    f"no teacher feature for video {cname}/{rec.video_id} "
                    f"({'train' if train else 'test'} split) — is "
                    "teacher_path pointing at a complete extraction tree? "
                    "(pass a strict=False FeatureStore to zero-fill instead)")
            else:
                feats = np.zeros((self.features.seq_len,
                                  self.features.feat_dim), np.float32)
        return clip, feats

    def _pick_view(self, support: bool, rng: np.random.Generator):
        """The camera of a clip in multi-view datasets (reference
        video_reader.py:266-272, run.py --cross_view/--fixed_view): supports
        from a random camera of all views (the released choice does not
        exclude the query camera), queries from ``views[query_view]``."""
        d = self.cfg.data
        if d.fixed_view is not None:
            return d.fixed_view
        if not d.cross_view:
            return None
        views = self.videos.views
        if not views:
            raise ValueError("cross_view needs a scanned view_root tree")
        if support:
            return views[int(rng.integers(len(views)))]
        if not 0 <= d.query_view < len(views):
            raise ValueError(
                f"--query_view {d.query_view} out of range: the view tree has "
                f"{len(views)} cameras ({views}); pass --view/--query_view "
                f"inside that range")
        return views[d.query_view]

    def _feature_record(self, rec, train: bool):
        if self.videos is None:
            return rec
        return self._feat_lookup.get(
            (train, self.videos.class_names[rec.class_id], rec.video_id))

    def build_episode(self, spec: EpisodeSpec, train: bool,
                      rng: np.random.Generator):
        index = self._index(train)
        jobs: List[Tuple] = []   # (record, is_support, label, real class)
        for label, (c, s_idx, q_idx) in enumerate(
                zip(spec.classes, spec.support_idx, spec.query_idx)):
            for i in s_idx:
                jobs.append((index.get(c, i), True, label, c))
            for i in q_idx:
                jobs.append((index.get(c, i), False, label, c))
        seeds = rng.integers(0, 2 ** 31, size=len(jobs))
        if self.pool is not None:
            loaded = list(self.pool.map(
                lambda jz: self._load_one(jz[0][0], train, jz[1],
                                          support=jz[0][1]),
                zip(jobs, seeds)))
        else:
            loaded = [self._load_one(j[0], train, s, support=j[1])
                      for j, s in zip(jobs, seeds)]

        sup, qry = [], []
        for (rec, is_sup, label, real_c), (clip, feats) in zip(jobs, loaded):
            (sup if is_sup else qry).append((clip, feats, label, real_c))
        if not sup or not qry:
            raise ValueError(
                f"episode spec yields {len(sup)} support / {len(qry)} query "
                f"videos (classes {list(spec.classes)}) — fixed-episode "
                "files must list at least one of each")
        rng.shuffle(sup)
        rng.shuffle(qry)

        def stack(items):
            clips = _maybe_stack([x[0] for x in items])
            feats = _maybe_stack([x[1] for x in items])
            labels = np.asarray([x[2] for x in items], np.int32)
            real = np.asarray([x[3] for x in items], np.int32)
            return clips, feats, labels, real

        s_clips, s_feats, s_labels, _ = stack(sup)
        q_clips, q_feats, q_labels, q_real = stack(qry)
        return (s_clips, s_feats, s_labels), (q_clips, q_feats, q_labels, q_real)

    def sample_batch(self, rng: np.random.Generator, n_episodes: int,
                     train: bool = True,
                     specs: Optional[List[EpisodeSpec]] = None,
                     return_meta: bool = False):
        """``n_episodes`` episodes (or the given ``specs``) as numpy arrays;
        with ``return_meta`` also their :class:`EpisodeMeta`. Without a
        video store the clip fields carry the features."""
        ep = self.cfg.episode
        queries = ep.query_per_class if train else ep.query_per_class_test
        index = self._index(train)
        if specs is None:
            specs = [draw_episode_spec(index, ep.way, ep.shot, queries, rng)
                     for _ in range(n_episodes)]
        parts = [self.build_episode(s, train, rng) for s in specs]
        s_clips = _maybe_stack([p[0][0] for p in parts])
        s_feats = _maybe_stack([p[0][1] for p in parts])
        q_clips = _maybe_stack([p[1][0] for p in parts])
        q_feats = _maybe_stack([p[1][1] for p in parts])
        batch = EpisodeBatch(
            support_clips=s_clips if s_clips is not None else s_feats,
            support_labels=np.stack([p[0][2] for p in parts]),
            query_clips=q_clips if q_clips is not None else q_feats,
            query_labels=np.stack([p[1][2] for p in parts]),
            support_feats=s_feats,
            query_feats=q_feats,
        )
        if not return_meta:
            return batch
        meta = EpisodeMeta(
            classes=np.asarray([s.classes for s in specs], np.int32),
            real_query_labels=np.stack([p[1][3] for p in parts]),
        )
        return batch, meta


def _maybe_stack(xs):
    return None if xs[0] is None else np.stack(xs)

"""Feature trees (the port's copy of ``litemkd_tpu/data/features.py:22-103``).

A feature tree is ``<root>/<class>/<video>/feature.npy``, one (T, D) array a
video: the per-modality trees that the MFM teacher reads, and the fused tree
that MFM extraction writes (reference ``extract_multi_feature.py:113-121``).
Files are read with ``np.load(mmap_mode='r')`` and copied once. A
multi-modal store zero-fills a modality that a video lacks, as the
reference does (``multi_video_reader.py:264-276``).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .splits import SplitIndex, VideoRecord, load_split_lists, scan_class_tree


def scan_feature_tree(root: str, split_lists: Dict[str, set]
                      ) -> Tuple[SplitIndex, SplitIndex, list]:
    """(train index, test index, class folder names) of one feature tree;
    a video folder holding no ``.npy`` file is skipped."""
    def make_record(class_id, video_folder, vdir):
        files = [f for f in sorted(os.listdir(vdir)) if f.endswith(".npy")]
        if not files:
            return None
        return VideoRecord(class_id, video_folder,
                           feature_path=os.path.join(vdir, files[0]))

    return scan_class_tree(root, split_lists, make_record)


class FeatureStore:
    """Feature tree + split lists → per-split indices + (T, D) loads.
    With ``strict=False`` a missing or malformed file loads as zeros."""

    def __init__(self, feature_path: str, annotation_dir: str, split: int,
                 seq_len: int, feat_dim: int, strict: bool = True):
        self.seq_len = seq_len
        self.feat_dim = feat_dim
        self.strict = strict
        split_lists = load_split_lists(annotation_dir, split)
        self.train_split, self.test_split, self.class_names = \
            scan_feature_tree(feature_path, split_lists)

    def split(self, train: bool) -> SplitIndex:
        return self.train_split if train else self.test_split

    def load(self, rec: VideoRecord) -> np.ndarray:
        try:
            arr = np.load(rec.feature_path, mmap_mode="r")
            return np.asarray(arr, dtype=np.float32).reshape(self.seq_len,
                                                             self.feat_dim)
        except (FileNotFoundError, ValueError):
            if self.strict:
                raise
            return np.zeros((self.seq_len, self.feat_dim), dtype=np.float32)


class MultiModalFeatureStore:
    """Per-modality feature trees (rgb/depth/flow/...). The first modality
    is the primary index; the others are looked up by (class NAME, video
    id), since a tree that lacks a class folder numbers its later classes
    differently. A modality missing for a video loads as zeros."""

    def __init__(self, modality_paths: Dict[str, str], annotation_dir: str,
                 split: int, seq_len: int, feat_dim: int):
        self.modalities = list(modality_paths)
        self.stores = {m: FeatureStore(p, annotation_dir, split, seq_len,
                                       feat_dim, strict=False)
                       for m, p in modality_paths.items()}
        self.seq_len, self.feat_dim = seq_len, feat_dim
        primary = self.stores[self.modalities[0]]
        self.train_split = primary.train_split
        self.test_split = primary.test_split
        self.class_names = primary.class_names
        self._lookup: Dict[tuple, VideoRecord] = {}
        for m, store in self.stores.items():
            for train in (True, False):
                idx = store.split(train)
                for cid in idx.classes():
                    cname = store.class_names[cid]
                    for rec in idx.videos_for_class(cid):
                        self._lookup[(m, train, cname, rec.video_id)] = rec

    def split(self, train: bool) -> SplitIndex:
        return self.train_split if train else self.test_split

    def load(self, rec: VideoRecord, modality: str, train: bool) -> np.ndarray:
        """(T, D) features of ``modality`` for the primary-index record;
        zeros when that modality is missing for the video."""
        hit = self._lookup.get((modality, train,
                                self.class_names[rec.class_id], rec.video_id))
        if hit is None:
            return np.zeros((self.seq_len, self.feat_dim), dtype=np.float32)
        return self.stores[modality].load(hit)

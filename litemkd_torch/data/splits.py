"""Split lists and the per-split video index (the port's copy of
``litemkd_tpu/data/splits.py:19-106``; the reference's ``Split`` and
``_select_fold``, ``video_reader.py:17-52, 305-318``).

Annotation files ``{train,test}list{split:02d}.txt`` hold one
``class/video_id`` per line; entries are normalised (spaces → '_',
lowercased, extension stripped, basename only), and videos go to the train
or test split by membership. Class ids follow the sorted class-folder order.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set


def load_split_lists(annotation_dir: str, split: int) -> Dict[str, Set[str]]:
    """Parse trainlistNN.txt / testlistNN.txt into normalized video-id sets."""
    out: Dict[str, Set[str]] = {}
    for name in ("train", "test"):
        path = os.path.join(annotation_dir, f"{name}list{split:02d}.txt")
        entries: Set[str] = set()
        with open(path) as f:
            for line in f:
                x = line.replace(" ", "_").lower().strip().split(" ")[0]
                x = os.path.splitext(os.path.split(x)[1])[0]
                if x:
                    entries.add(x)
        out[name] = entries
    return out


def scan_class_tree(root: str, split_lists: Dict[str, Set[str]], make_record):
    """Shared ``<root>/<class>/<video>/...`` tree walk (the reference scan,
    video_reader.py:174-196): class ids follow sorted class-folder order,
    videos are assigned to train/test by lowercase folder membership in the
    split lists. ``make_record(class_id, video_folder, video_dir)`` builds the
    per-leaf record (frame list or feature path) or returns None to skip the
    video. One walker for both the frame and feature trees keeps their class
    numbering rules identical (the stores pair videos to features by class
    NAME, but a single implementation removes the drift hazard entirely)."""
    train, test = SplitIndex(), SplitIndex()
    class_folders = sorted(os.listdir(root))
    for class_id, class_folder in enumerate(class_folders):
        cdir = os.path.join(root, class_folder)
        if not os.path.isdir(cdir):
            continue
        for video_folder in sorted(os.listdir(cdir)):
            key = video_folder.lower()
            if key in split_lists["train"]:
                dest = train
            elif key in split_lists["test"]:
                dest = test
            else:
                continue
            rec = make_record(class_id, video_folder,
                              os.path.join(cdir, video_folder))
            if rec is not None:
                dest.add(rec)
    return train, test, class_folders


@dataclass
class VideoRecord:
    """One video: either a list of frame paths or a single feature-file path."""

    class_id: int
    video_id: str
    frame_paths: Optional[List[str]] = None   # RGB frame tree entry
    feature_path: Optional[str] = None        # <...>/feature.npy entry

    @property
    def n_frames(self) -> int:
        return len(self.frame_paths) if self.frame_paths else 0


class SplitIndex:
    """Class-id → videos lookup with O(1) random draws."""

    def __init__(self) -> None:
        self._by_class: Dict[int, List[VideoRecord]] = {}
        self._n = 0

    def add(self, rec: VideoRecord) -> None:
        self._by_class.setdefault(rec.class_id, []).append(rec)
        self._n += 1

    def classes(self) -> List[int]:
        return sorted(self._by_class)

    def n_videos(self, class_id: int) -> int:
        return len(self._by_class.get(class_id, []))

    def get(self, class_id: int, idx: int) -> VideoRecord:
        return self._by_class[class_id][idx]

    def videos_for_class(self, class_id: int) -> List[VideoRecord]:
        return self._by_class[class_id]

    def __len__(self) -> int:
        return self._n

    def summary(self) -> str:
        return f"{len(self)} videos over {len(self._by_class)} classes"

"""RGB frame store (port of ``litemkd_tpu/data/video.py:33-340``):
directory and zip scanning, frame sampling, decode and augmentation on the
host.

The augmentation is the reference's: shorter-side bilinear resize to
``round(img_size·256/224)``, a random horizontal flip and a random
``img_size`` crop at train time, a centre crop at test time. Clips leave as
(T, H, W, 3) uint8; the trunk scales pixels to [0, 1] on the device. The
random draws are the JAX package's, in the same order (the flip, then y0,
then x0), so one seed gives the same clip in both packages. JPEG clips go
through the C++ decoder (:mod:`litemkd_torch.native`) where it builds, and
through PIL otherwise; each path says once on stdout that it is in use.
"""
from __future__ import annotations

import io
import os
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .splits import SplitIndex, VideoRecord, load_split_lists, scan_class_tree

try:  # feature-only runs never need PIL
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

_IMG_EXTS = (".jpg", ".jpeg", ".png")

decoders_used: set = set()   # the clip decoders ("native", "pil") that ran
_decoders_lock = threading.Lock()


def _note_decoder(name: str) -> None:
    """Record that decoder ``name`` produced a clip; say so once."""
    if name in decoders_used:
        return
    with _decoders_lock:
        if name not in decoders_used:
            decoders_used.add(name)
            print(f"[video] clip decoder in use: {name}", flush=True)


def scan_frame_tree(root: str, split_lists: Dict[str, set],
                    seq_len: int) -> Tuple[SplitIndex, SplitIndex, List[str]]:
    """Scan ``<root>/<class>/<video>/<frame.jpg>`` into train/test indices.

    Videos with fewer than ``seq_len`` frames are skipped; assignment is by
    lowercase video-folder membership in the split lists; class ids follow
    sorted class-folder order (the reference's scan, video_reader.py:174-196).
    """
    def make_record(class_id, video_folder, vdir):
        frames = sorted(os.path.join(vdir, f) for f in os.listdir(vdir)
                        if f.lower().endswith(_IMG_EXTS))
        if len(frames) < seq_len:
            return None
        return VideoRecord(class_id, video_folder, frame_paths=frames)

    return scan_class_tree(root, split_lists, make_record)


class ZipFrameStore:
    """In-RAM zip of frames (the reference's 'szip' path, video_reader.py:120-172)."""

    def __init__(self, zip_path: str):
        with open(zip_path, "rb") as f:
            self._mem = f.read()
        self.zfile = zipfile.ZipFile(io.BytesIO(self._mem))

    def scan(self, split_lists: Dict[str, set],
             seq_len: int) -> Tuple[SplitIndex, SplitIndex, List[str]]:
        train, test = SplitIndex(), SplitIndex()
        by_video: Dict[Tuple[str, str], List[str]] = {}
        for name in self.zfile.namelist():
            if not name.lower().endswith(_IMG_EXTS):
                continue
            parts = name.split(os.sep)
            if len(parts) < 3:
                continue
            class_folder, video_folder = parts[-3], parts[-2]
            by_video.setdefault((class_folder, video_folder), []).append(name)
        class_folders = sorted({c for c, _ in by_video})
        class_idx = {c: i for i, c in enumerate(class_folders)}
        for (class_folder, video_folder), frames in sorted(by_video.items()):
            if len(frames) < seq_len:
                continue
            key = video_folder.lower()
            dest = (train if key in split_lists["train"]
                    else test if key in split_lists["test"] else None)
            if dest is None:
                continue
            dest.add(VideoRecord(class_idx[class_folder], video_folder,
                                 frame_paths=sorted(frames)))
        return train, test, class_folders

    def read(self, path: str) -> "Image.Image":
        with self.zfile.open(path) as f:
            img = Image.open(f)
            img.load()
            return img

    def read_bytes(self, path: str) -> bytes:
        return self.zfile.read(path)


def sample_frame_indices(n_frames: int, seq_len: int, train: bool,
                         rng: np.random.Generator) -> np.ndarray:
    """The reference's frame-index math (video_reader.py:345-376):

    train: randomly trim up to min(5, excess/2) frames from each end, then
    linspace ``seq_len`` indices; test: fixed trim of 1 frame each end.
    """
    if n_frames == seq_len:
        return np.arange(seq_len)
    if train:
        excess = n_frames - seq_len
        pad = int(min(5, excess / 2))
        if pad < 1:
            start, end = 0, n_frames - 1
        else:
            start = int(rng.integers(0, pad + 1))
            end = int(rng.integers(n_frames - 1 - pad, n_frames))
    else:
        start, end = 1, n_frames - 2
    if end - start < seq_len:
        start, end = 0, n_frames - 1
    if seq_len == 1:
        # one random frame from the trimmed range (video_reader.py:373-374,
        # at train and at test time)
        return np.asarray([int(rng.integers(start, end))], np.int64)
    idx = np.linspace(start, end, num=seq_len)
    return idx.astype(np.int64)


def sample_frame_indices_aux(n_frames: int, seq_len: int,
                             rng: Optional[np.random.Generator] = None
                             ) -> np.ndarray:
    """The per-video frame rule of ``AuxDataset.get_seq`` (extraction and
    pretraining): ``linspace(0, n-1)`` with no trim and no randomness, for
    ``seq_len == 1`` too (frame 0). ``rng`` is accepted and unused."""
    del rng
    if n_frames == seq_len:
        return np.arange(seq_len)
    return np.linspace(0, n_frames - 1, num=seq_len).astype(np.int64)


def _resize_shorter(img: "Image.Image", size: int) -> "Image.Image":
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return img.resize((ow, oh), Image.BILINEAR)


def _center_offset(margin: int) -> int:
    """CenterCrop origin: the reference rounds (``int(round((im_h-h)/2.))``,
    videotransforms/video_transforms.py:243-244) rather than flooring."""
    return int(round(margin / 2))


def _resized_dims(w: int, h: int, size: int) -> Tuple[int, int]:
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def load_clip_native(paths: List[str], idxs: np.ndarray, *, img_size: int,
                     train: bool, rng: np.random.Generator,
                     resize_to: int = 256,
                     zip_store: Optional[ZipFrameStore] = None
                     ) -> Optional[np.ndarray]:
    """The C++ decode path; None sends the caller to :func:`load_clip`.

    The crop and flip draws consume ``rng`` as the PIL path does. With
    ``zip_store`` the frames' JPEG bytes go to the in-memory decoder."""
    from .. import native
    if not native.available():
        return None
    sel = [paths[int(i)] for i in idxs]
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in sel):
        return None
    blobs = None
    if zip_store is not None:
        blobs = [zip_store.read_bytes(p) for p in sel]
        probe_src = io.BytesIO(blobs[0])
    else:
        probe_src = sel[0]
    with Image.open(probe_src) as probe:   # header only: dims before decode
        w, h = probe.size
    rw, rh = _resized_dims(w, h, resize_to)
    if train:
        flip = rng.random() < 0.5
        y0 = int(rng.integers(0, rh - img_size + 1))
        x0 = int(rng.integers(0, rw - img_size + 1))
        if flip:
            # the PIL path flips the whole image before cropping at x0; the
            # C++ decoder flips inside the crop window, so mirror the window
            x0 = rw - img_size - x0
    else:
        flip = False
        y0 = _center_offset(rh - img_size)
        x0 = _center_offset(rw - img_size)
    if blobs is not None:
        clip = native.decode_clip_mem(blobs, resize_to, y0, x0, img_size, flip)
    else:
        clip = native.decode_clip(sel, resize_to, y0, x0, img_size, flip)
    if clip is not None:
        _note_decoder("native")
    return clip


def load_clip(paths: List[str], idxs: np.ndarray, *, img_size: int, train: bool,
              rng: np.random.Generator, resize_to: int = 256,
              zip_store: Optional[ZipFrameStore] = None) -> np.ndarray:
    """Decode the selected frames with PIL, apply the clip's augmentation
    and return (T, H, W, 3) uint8."""
    imgs = []
    for i in idxs:
        p = paths[int(i)]
        img = zip_store.read(p) if zip_store is not None else Image.open(p)
        img = img.convert("RGB")
        img = _resize_shorter(img, resize_to)
        imgs.append(np.asarray(img, dtype=np.uint8))
    clip = np.stack(imgs)  # (T, H, W, 3) uint8
    t, h, w, _ = clip.shape
    if train:
        if rng.random() < 0.5:
            clip = clip[:, :, ::-1, :]
        y0 = int(rng.integers(0, h - img_size + 1))
        x0 = int(rng.integers(0, w - img_size + 1))
    else:
        y0 = _center_offset(h - img_size)
        x0 = _center_offset(w - img_size)
    clip = clip[:, y0:y0 + img_size, x0:x0 + img_size, :]
    _note_decoder("pil")
    return np.ascontiguousarray(clip)


class VideoStore:
    """Frame tree (dir or zip) + split lists → per-split indices + clip loads.

    With ``use_native`` (the default) JPEG clips go through the C++ decoder
    where it is available, and through PIL otherwise."""

    def __init__(self, rgb_path: str, annotation_dir: str, split: int,
                 seq_len: int, img_size: int, use_native: bool = True,
                 view_root: Optional[str] = None):
        self.seq_len = seq_len
        self.img_size = img_size
        self.use_native = use_native
        # multi-camera tree all_view_rgb_l8/<view>/<class>/<video> for the
        # cross-view sampling mode (reference video_reader.py:255-274)
        self.view_root = view_root
        self.views: List[str] = (sorted(os.listdir(view_root))
                                 if view_root else [])
        # the shorter-side resize follows the crop size (video_reader.py:
        # 96-101: 96 for img_size 84, 256 for 224, both img_size·256/224)
        self.resize_to = round(img_size * 256 / 224)
        self.zip_store: Optional[ZipFrameStore] = None
        split_lists = load_split_lists(annotation_dir, split)
        if rgb_path.endswith(".zip"):
            self.zip_store = ZipFrameStore(rgb_path)
            self.train_split, self.test_split, self.class_names = \
                self.zip_store.scan(split_lists, seq_len)
        else:
            self.train_split, self.test_split, self.class_names = \
                scan_frame_tree(rgb_path, split_lists, seq_len)

    def split(self, train: bool) -> SplitIndex:
        return self.train_split if train else self.test_split

    def load(self, rec: VideoRecord, train: bool, rng: np.random.Generator,
             frame_rule: str = "episode") -> np.ndarray:
        """``rec``'s clip. ``frame_rule``: "episode", the episodic readers'
        trimmed linspace of frames (:func:`sample_frame_indices`), or
        "aux", AuxDataset's plain linspace (:func:`sample_frame_indices_aux`,
        pretraining and expert extraction). ``train`` picks the pixel
        transforms under both rules (flip and random crop, or centre
        crop)."""
        if frame_rule == "aux":
            idxs = sample_frame_indices_aux(rec.n_frames, self.seq_len)
        elif frame_rule == "episode":
            idxs = sample_frame_indices(rec.n_frames, self.seq_len, train, rng)
        else:
            raise ValueError(f"unknown frame_rule {frame_rule!r}")
        return self._load(rec.frame_paths, idxs, train, rng, self.zip_store)

    def load_view(self, rec: VideoRecord, view: str, train: bool,
                  rng: np.random.Generator) -> np.ndarray:
        """``rec``'s clip from one camera of the multi-view tree (reference
        ``get_cross_view_rgb_seq``, video_reader.py:255-313). The view
        directory is listed at load, so its frame count may differ from the
        primary tree's."""
        if self.view_root is None:
            raise ValueError("cross/fixed-view sampling needs a view_root "
                             "(all_view_rgb_l8-style tree)")
        vdir = os.path.join(self.view_root, view,
                            self.class_names[rec.class_id], rec.video_id)
        paths = [os.path.join(vdir, f) for f in sorted(os.listdir(vdir))
                 if f.lower().endswith(_IMG_EXTS)]   # same filter as the scan
        if len(paths) < self.seq_len:
            raise ValueError(
                f"view clip {vdir} has {len(paths)} frames < seq_len "
                f"{self.seq_len} (the primary tree skips such videos at scan; "
                f"per-view trees are only listed at load)")
        idxs = sample_frame_indices(len(paths), self.seq_len, train, rng)
        return self._load(paths, idxs, train, rng, None)

    def _load(self, paths, idxs, train, rng, zip_store) -> np.ndarray:
        if self.use_native:
            clip = load_clip_native(paths, idxs, img_size=self.img_size,
                                    train=train, rng=rng,
                                    resize_to=self.resize_to,
                                    zip_store=zip_store)
            if clip is not None:
                return clip
        return load_clip(paths, idxs, img_size=self.img_size, train=train,
                         rng=rng, zip_store=zip_store,
                         resize_to=self.resize_to)

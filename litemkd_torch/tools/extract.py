"""Feature extraction: per-video expert features and fused MFM features
(port of ``extract_expert_features`` and ``extract_mfm_features``,
``litemkd_tpu/tools/extract.py:71-180``; the reference's
``extract_feature.py:80-92`` and ``extract_multi_feature.py:113-121``).

Both write ``<out>/<class>/<video>/feature.npy``, one (T, D) fp32 array a
video of both splits: per-modality trunk features (the ``<modality>`` trees
that the MFM teacher reads), or fused features (the ``teacher_path`` tree
that the student's distillation reads). A :class:`Prefetcher` thread
assembles batch k+1 and copies it from pinned memory while the device runs
batch k, and batch k's results are read back and saved only after batch
k+1 has been dispatched (:class:`DeferredHostSync`). Then the first training
video runs again alone and must match its saved file within
max(1e-4, 1e-2·max|saved|), the JAX package's self-consistency check; a
mismatch raises.
"""
from __future__ import annotations

import inspect
import os

import numpy as np
import torch
from torch import nn

from ..data.features import MultiModalFeatureStore
from ..data.prefetch import DeferredHostSync, Prefetcher
from ..data.splits import SplitIndex
from ..data.video import VideoStore
from ..models.backbones.classifier_net import ActionRecognitionNet
from ..train.loop import move_to_device


def _save_feature(out_root: str, class_name: str, video_id: str,
                  feature: np.ndarray) -> str:
    d = os.path.join(out_root, class_name, video_id)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "feature.npy")
    np.save(path, feature)
    return path


def _iter_records(index: SplitIndex):
    for c in index.classes():
        yield from index.videos_for_class(c)


def extract_mfm_features(store: MultiModalFeatureStore, model: nn.Module,
                         out_root: str, batch_size: int,
                         fusion_kind: str = "mfm", side: int = 0) -> int:
    """Fuse every video of both splits through ``model.extract`` (a fusion
    teacher of ``fusion_kind``) on the model's device in batches of
    ``batch_size`` videos and write the feature tree under the store's
    class names; returns the number of videos written. ``side`` 1 dumps
    the query-side fusion of a composer preset whose sides differ; a
    teacher whose ``extract`` takes no side refuses it, and TSF has no
    ``extract`` at all. Batch statistics and video-axis attention run over
    each extraction batch, as in the JAX package.

    A :class:`Prefetcher` thread reads batch k+1 from disk and copies it
    from pinned memory while the device fuses batch k, and batch k's
    results are read back and saved only after batch k+1 has been
    dispatched (:class:`DeferredHostSync`). Then the
    first training video is fused again alone and must match its saved
    file within max(1e-4, 1e-2·max|saved|), the JAX package's
    self-consistency check; a mismatch raises."""
    kw = ({"side": side}
          if "side" in inspect.signature(model.extract).parameters else {})
    if side and not kw:
        raise ValueError(f"fusion kind {fusion_kind!r} is side-symmetric; "
                         "query-side extraction does not apply")
    device = next(model.parameters()).device
    class_names = store.class_names
    model.eval()
    jobs = []
    for train in (True, False):
        records = list(_iter_records(store.split(train)))
        jobs += [(train, records[i:i + batch_size])
                 for i in range(0, len(records), batch_size)]

    def read(i):
        train, recs = jobs[i]
        return {m: np.stack([store.load(r, m, train) for r in recs])
                for m in store.modalities}

    def fuse(feats):
        with torch.inference_mode():
            return model.extract(feats, **kw)

    count = 0

    def sink(job, fused):
        nonlocal count
        for rec, f in zip(job[1], fused.float().cpu().numpy()):
            _save_feature(out_root, class_names[rec.class_id], rec.video_id, f)
            count += 1

    deferred = DeferredHostSync(sink)
    for i, feats in enumerate(Prefetcher(
            read, len(jobs),
            transfer=lambda b: move_to_device(b, device))):
        deferred.push(jobs[i], fuse(feats))
    deferred.flush()

    if count:
        rec = next(_iter_records(store.split(True)))
        fresh = fuse(move_to_device({m: np.stack([store.load(rec, m, True)])
                                     for m in store.modalities}, device))
        _check_saved(fresh[0].float().cpu().numpy(), out_root,
                     class_names[rec.class_id], rec.video_id)
    return count


def _check_saved(fresh: np.ndarray, out_root: str, class_name: str,
                 video_id: str) -> None:
    """The self-consistency check: ``fresh`` against the saved file within
    max(1e-4, 1e-2·max|saved|). A bf16 trunk rounds differently at another
    batch shape, so the bound scales with the features; a pairing or shape
    fault exceeds it by orders of magnitude."""
    saved = np.load(os.path.join(out_root, class_name, video_id, "feature.npy"))
    tol = max(1e-4, 1e-2 * float(np.abs(saved).max()))
    if fresh.shape != saved.shape:
        raise RuntimeError(
            "extraction self-consistency check failed on "
            f"{class_name}/{video_id}: shape {fresh.shape}, saved {saved.shape}")
    if not np.allclose(fresh, saved, rtol=0.0, atol=tol):
        raise RuntimeError(
            "extraction self-consistency check failed on "
            f"{class_name}/{video_id}: max|Δ|={np.abs(fresh - saved).max():.3e} "
            f"(‖saved‖∞={np.abs(saved).max():.3e}, tol={tol:.3e})")


def extract_expert_features(video_store: VideoStore, model: ActionRecognitionNet,
                            out_root: str, batch_size: int) -> int:
    """Every video of both splits through ``model.expert_features`` (4×4
    adaptive max-pool, 16-patch mean) on the model's device in batches of
    ``batch_size`` clips, written under the store's class names; returns
    the number of videos written. Clips take the aux frame rule with centre
    crops (the reference extracts through ``AuxDataset`` in test mode)."""
    device = next(model.parameters()).device
    class_names = video_store.class_names
    model.eval()
    rng = np.random.default_rng(0)
    jobs = []
    for train in (True, False):
        records = list(_iter_records(video_store.split(train)))
        jobs += [records[i:i + batch_size]
                 for i in range(0, len(records), batch_size)]

    def load(rec):
        return video_store.load(rec, False, rng, frame_rule="aux")

    def features(clips):
        with torch.inference_mode():
            return model.expert_features(clips)

    count = 0

    def sink(recs, feats):
        nonlocal count
        for rec, f in zip(recs, feats.float().cpu().numpy()):
            _save_feature(out_root, class_names[rec.class_id], rec.video_id, f)
            count += 1

    deferred = DeferredHostSync(sink)
    for i, clips in enumerate(Prefetcher(
            lambda i: np.stack([load(r) for r in jobs[i]]), len(jobs),
            transfer=lambda b: move_to_device(b, device))):
        deferred.push(jobs[i], features(clips))
    deferred.flush()

    if count:
        rec = next(_iter_records(video_store.split(True)))
        fresh = features(move_to_device(load(rec)[None], device))
        _check_saved(fresh[0].float().cpu().numpy(), out_root,
                     class_names[rec.class_id], rec.video_id)
    return count

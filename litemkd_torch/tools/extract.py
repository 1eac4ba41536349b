"""Fused-feature extraction with the MFM teacher (port of
``extract_mfm_features``, ``litemkd_tpu/tools/extract.py:122-180``; the
reference's ``extract_multi_feature.py:113-121``).

Writes ``<out>/<class>/<video>/feature.npy``, one fused (T, D) array a video
of both splits: the ``teacher_path`` tree that the student's distillation
reads. Expert (per-modality trunk) extraction is not ported yet.
"""
from __future__ import annotations

import os
import numpy as np
import torch

from ..data.features import MultiModalFeatureStore
from ..data.prefetch import DeferredHostSync, Prefetcher
from ..data.splits import SplitIndex
from ..models.teacher import MFMTeacher
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


def extract_mfm_features(store: MultiModalFeatureStore, model: MFMTeacher,
                         out_root: str, batch_size: int) -> int:
    """Fuse every video of both splits through ``model.extract`` on the
    model's device in batches of ``batch_size`` videos and write the
    feature tree under the store's class names; returns the number of
    videos written.

    A :class:`Prefetcher` thread reads batch k+1 from disk and copies it
    from pinned memory while the device fuses batch k, and batch k's
    results are read back and saved only after batch k+1 has been
    dispatched (:class:`DeferredHostSync`). Then the
    first training video is fused again alone and must match its saved
    file within max(1e-4, 1e-2·max|saved|), the JAX package's
    self-consistency check; a mismatch raises."""
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
            return model.extract(feats)

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
        fresh = fresh[0].float().cpu().numpy()
        saved = np.load(os.path.join(out_root, class_names[rec.class_id],
                                     rec.video_id, "feature.npy"))
        tol = max(1e-4, 1e-2 * float(np.abs(saved).max()))
        if not np.allclose(fresh, saved, rtol=0.0, atol=tol):
            raise RuntimeError(
                "extraction self-consistency check failed: "
                f"max|Δ|={np.abs(fresh - saved).max():.3e} "
                f"(‖saved‖∞={np.abs(saved).max():.3e}, tol={tol:.3e})")
    return count

"""Episode-assembly throughput benchmark (the host data path).

Measures end-to-end episode assembly — JPEG decode, resize/crop/flip, stack —
in episodes/s for the native C++ decoder (litemkd_torch.native, libjpeg,
GIL-free) vs the PIL fallback, over a synthetic on-disk frame tree. This is
the analog of profiling the reference's DataLoader workers
(``video_reader.py:398-485``, the reference's stated CPU bottleneck).
Port of ``litemkd_tpu/tools/pipeline_bench.py`` on the port's data path; it
needs no GPU.

    python -m litemkd_torch.tools.pipeline_bench [--episodes 8] [--img 224]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def build_tree(root: str, n_classes: int, vids: int, frames: int,
               hw: int) -> None:
    from PIL import Image
    rng = np.random.default_rng(0)
    for c in range(n_classes):
        for v in range(vids):
            d = os.path.join(root, f"class{c:02d}", f"vid{v:02d}")
            os.makedirs(d)
            for f in range(frames):
                arr = rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{f:05d}.jpg"),
                                          quality=90)


def bench(root: str, splits: str, cfg, episodes: int, use_native: bool,
          iters: int = 3) -> float:
    from ..data import VideoStore, EpisodeSampler
    vs = VideoStore(root, splits, 3, cfg.episode.seq_len,
                    cfg.episode.img_size, use_native=use_native)
    sampler = EpisodeSampler(cfg, vs)
    try:
        rng = np.random.default_rng(0)
        sampler.sample_batch(rng, episodes, train=True)      # warm caches
        t0 = time.time()
        for _ in range(iters):
            sampler.sample_batch(rng, episodes, train=True)
        return iters * episodes / (time.time() - t0)
    finally:
        if sampler.pool is not None:
            sampler.pool.shutdown()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--episodes", type=int, default=4)
    p.add_argument("--img", type=int, default=224)
    p.add_argument("--way", type=int, default=5)
    p.add_argument("--shot", type=int, default=5)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--zip", action="store_true",
                   help="bench the in-RAM zip store (ssv2 'szip' path) "
                        "instead of the directory tree")
    args = p.parse_args(argv)

    from .. import native
    from ..config import preset
    base = preset("tiny")
    cfg = base.replace(episode=base.episode.__class__(
        way=args.way, shot=args.shot, query_per_class=5,
        query_per_class_test=1, seq_len=args.frames, img_size=args.img))

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "rgb_l8")
        build_tree(root, n_classes=args.way + 2, vids=12, frames=args.frames,
                   hw=args.img + 32)
        ann = os.path.join(tmp, "splits")
        os.makedirs(ann)
        lines = [f"class{c:02d}/vid{v:02d}"
                 for c in range(args.way + 2) for v in range(12)]
        with open(os.path.join(ann, "trainlist03.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(ann, "testlist03.txt"), "w") as f:
            f.write("\n".join(lines[:12]) + "\n")

        if args.zip:
            import zipfile
            zp = os.path.join(tmp, "frames.zip")
            with zipfile.ZipFile(zp, "w") as zf:
                for r, _, files in os.walk(root):
                    for fn in sorted(files):
                        full = os.path.join(r, fn)
                        zf.write(full, os.path.relpath(full, tmp))
            root = zp
            print("store: in-RAM zip")

        pil = bench(root, ann, cfg, args.episodes, use_native=False)
        if native.available():
            nat = bench(root, ann, cfg, args.episodes, use_native=True)
            print(f"native C++ decode: {nat:6.2f} episodes/s")
        else:
            nat = None
            print("native decoder unavailable (no g++/libjpeg)")
        print(f"PIL decode:        {pil:6.2f} episodes/s")
        if nat:
            print(f"speedup:           {nat / pil:.2f}x")


if __name__ == "__main__":
    main()

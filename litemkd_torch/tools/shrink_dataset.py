"""Dataset shrinker: reduce every video folder to ``n`` linspace-sampled frames
(reference ``teacher/code/scripts/shrink_dataset.py:13-25`` — builds the 'l8'
trees the whole pipeline consumes). Port of
``litemkd_tpu/tools/shrink_dataset.py``.

    python -m litemkd_torch.tools.shrink_dataset SRC_TREE DST_TREE [--frames 8]
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def shrink(src: str, dst: str, n_frames: int = 8) -> int:
    count = 0
    for class_folder in sorted(os.listdir(src)):
        cdir = os.path.join(src, class_folder)
        if not os.path.isdir(cdir):
            continue
        for video_folder in sorted(os.listdir(cdir)):
            vdir = os.path.join(cdir, video_folder)
            frames = sorted(f for f in os.listdir(vdir)
                            if f.lower().endswith((".jpg", ".jpeg", ".png")))
            if not frames:
                continue
            idx = np.linspace(0, len(frames) - 1, num=min(n_frames, len(frames)))
            keep = [frames[int(i)] for i in idx]
            out = os.path.join(dst, class_folder, video_folder)
            os.makedirs(out, exist_ok=True)
            for k, f in enumerate(keep):
                shutil.copyfile(os.path.join(vdir, f),
                                os.path.join(out, f"{k:05d}{os.path.splitext(f)[1]}"))
            count += 1
    return count


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    n = shrink(args.src, args.dst, args.frames)
    print(f"shrunk {n} videos → {args.dst}")


if __name__ == "__main__":
    main()

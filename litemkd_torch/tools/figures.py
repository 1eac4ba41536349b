"""Paper-figure helpers: modality grids and 3D skeleton plots.

Rebuild of the reference's two matplotlib figure scripts:

- ``teacher/code/huatu.py`` — an (videos × modalities) grid of the first frame
  of each video's rgb/depth/flow ``<modality>_l8`` directory (huatu.py:19-43).
- ``teacher/code/scripts/3d_visualization.py`` — a 3D Human3.6M skeleton
  rendering with left/right-colored bones (3d_visualization.py:5-23).

Both are plain-host utilities (PIL + matplotlib, no cv2 dependency); the
entry point is ``python -m litemkd_torch.cli.figures``. This is the port's
own copy of ``litemkd_tpu/tools/figures.py`` (the port imports nothing of
the JAX package).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

# H36M bone list: (start joint, end joint, is_left) — 3d_visualization.py:5-7
HUMAN36M_BONES = [
    (0, 1, 0), (1, 2, 0), (2, 6, 0), (5, 4, 1), (4, 3, 1), (3, 6, 1),
    (6, 7, 0), (7, 8, 0), (8, 16, 0), (9, 16, 0), (8, 12, 0), (11, 12, 0),
    (10, 11, 0), (8, 13, 1), (13, 14, 1), (14, 15, 1),
]


def _first_frame(video_dir: str, size: int = 224) -> np.ndarray:
    """First (sorted) image of a frame directory, resized to (size, size, 3)
    — matches huatu.py:26-31 (cv2.imread + resize, BGR→RGB) via PIL."""
    from PIL import Image

    names = sorted(f for f in os.listdir(video_dir)
                   if not f.startswith("."))
    if not names:
        raise FileNotFoundError(f"no frames under {video_dir}")
    with Image.open(os.path.join(video_dir, names[0])) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im)


def modality_grid(data_root: str,
                  rows: Sequence[Tuple[str, str, str]],
                  modalities: Sequence[str] = ("rgb", "depth", "flow"),
                  out_path: str = "multi_modality.pdf",
                  img_size: int = 224):
    """Render a (len(rows) × len(modalities)) first-frame grid.

    ``rows`` is a list of (dataset, class, video) triples; each cell reads
    ``<data_root>/<dataset>/<modality>_l8/<class>/<video>`` like
    huatu.py:22-27. Returns the output path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nrows, ncols = len(rows), len(modalities)
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols,
                             figsize=(2 * ncols, 2 * nrows), squeeze=False)
    for i, (dataset, cname, vname) in enumerate(rows):
        for j, modality in enumerate(modalities):
            vdir = os.path.join(data_root, dataset, f"{modality}_l8",
                                cname, vname)
            axes[i][j].imshow(_first_frame(vdir, img_size))
            axes[i][j].axis("off")
    for j, modality in enumerate(modalities):
        axes[0][j].set_title(modality.upper(), fontsize=12)
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return out_path


def _plot_bones(ax, pose, bones, lcolor, rcolor, lw=2):
    for a, b, is_left in bones:
        xs, ys, zs = (np.array([pose[a, k], pose[b, k]]) for k in range(3))
        ax.plot(xs, ys, zs, lw=lw, c=lcolor if is_left else rcolor)


def draw_skeleton_3d(pose_3d: np.ndarray,
                     out_path: str = "skeleton.jpg",
                     bones=HUMAN36M_BONES,
                     lcolor: str = "#3498db", rcolor: str = "#e74c3c",
                     radius: float = 10.0, root_joint: int = 5):
    """Plot one (V, 3) skeleton with left/right-colored bones and a cube of
    ``radius`` around ``root_joint`` (3d_visualization.py:10-23)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pose_3d = np.asarray(pose_3d, np.float64)
    if pose_3d.ndim != 2 or pose_3d.shape[1] != 3:
        raise ValueError(f"expected (V, 3) joints, got {pose_3d.shape}")
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    _plot_bones(ax, pose_3d, bones, lcolor, rcolor)
    xr, yr, zr = pose_3d[root_joint]
    ax.set_xlim3d([xr - radius, xr + radius])
    ax.set_ylim3d([yr - radius, yr + radius])
    ax.set_zlim3d([0, zr + 2 * radius])
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def skeleton_clip_grid(skeleton: np.ndarray,
                       out_path: str = "skeleton_clip.jpg",
                       bones=HUMAN36M_BONES,
                       lcolor: str = "#3498db", rcolor: str = "#e74c3c",
                       max_frames: int = 8):
    """Grid of per-frame 3D skeleton plots for a (T, V, 3) clip — the
    clip-level analog the demo/episode browser uses."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    skeleton = np.asarray(skeleton, np.float64)
    t = min(skeleton.shape[0], max_frames)
    fig = plt.figure(figsize=(2.2 * t, 2.4))
    for f in range(t):
        ax = fig.add_subplot(1, t, f + 1, projection="3d")
        _plot_bones(ax, skeleton[f], bones, lcolor, rcolor, lw=1.5)
        ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path

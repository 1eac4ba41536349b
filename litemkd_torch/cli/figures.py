"""Figure generator: modality grids, confusion matrices, Grad-CAM overlays
and 3D skeleton plots (port of ``litemkd_tpu/cli/figures.py``; the
reference's ``teacher/code/huatu.py``, ``heatmap_vis.py`` and
``teacher/code/scripts/3d_visualization.py``).

    # (videos × modalities) grid; each --row is dataset:class:video
    python -m litemkd_torch.cli.figures grid --data_root <root> \\
        --row ucf:GolfSwing:v_GolfSwing_g01_c03 --row hmdb:run:vid001 \\
        --modalities rgb depth flow --out multi_modality.pdf

    # one skeleton .npy → 3D bone plot (first frame, or --frame / --clip)
    python -m litemkd_torch.cli.figures skeleton --npy <S3D.npy> --out pose.jpg

    # real-class confusion matrix from an eval's per-task log
    python -m litemkd_torch.cli.figures confusion --log tasks.jsonl \\
        --out confusion.csv --png confusion.png

    # Grad-CAM of one frame through a cli.pretrain checkpoint
    python -m litemkd_torch.cli.figures cam --image frame.jpg \\
        --ckpt PRETRAIN_DIR --arch resnet50 --out cam.jpg [--device cpu]

``cam --ckpt`` reads the port's ``cli.pretrain`` checkpoint (a
``checkpoint_<n>.pt`` or its directory, whose newest file is taken) or any
``.pt`` of that layout (``convnet.*``, ``fc.*``); the JAX package reads
Orbax, which needs JAX. Without ``--ckpt`` the trunk and probe are random
from seed 0 (torchvision's pretrained weights cannot be downloaded
offline). ``cam`` runs on ``--device`` (cuda by default).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..tools.figures import draw_skeleton_3d, modality_grid, skeleton_clip_grid


def load_cam_model(ckpt, arch: str, num_classes, device):
    """The fp32 eval-mode ``ActionRecognitionNet`` of ``cam``: from a
    pretrain checkpoint (a file, or a directory's newest), or random from
    seed 0 with ``num_classes`` (101 by default) classes."""
    import torch
    from ..models.backbones.classifier_net import ActionRecognitionNet
    from ..models.student import init_student_
    depth = int(arch.replace("resnet", ""))
    if ckpt:
        from ..tools.weights import load_reference_checkpoint
        from ..train import CheckpointManager
        path = ckpt
        if os.path.isdir(ckpt):
            mgr = CheckpointManager(ckpt)
            if mgr.latest_step() is None:
                raise FileNotFoundError(f"{ckpt} holds no checkpoint_<n>.pt")
            path = mgr.path(mgr.latest_step())
        sd = load_reference_checkpoint(path)[0]
        net = ActionRecognitionNet(int(sd["fc.weight"].shape[0]), depth=depth,
                                   compute_dtype=torch.float32)
        net.load_state_dict(sd, strict=True)
    else:
        net = ActionRecognitionNet(num_classes or 101, depth=depth,
                                   compute_dtype=torch.float32)
        init_student_(net, torch.Generator().manual_seed(0))
    return net.to(device).eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grid", help="modality first-frame grid (huatu.py)")
    g.add_argument("--data_root", required=True)
    g.add_argument("--row", action="append", required=True,
                   help="dataset:class:video (repeatable)")
    g.add_argument("--modalities", nargs="+", default=["rgb", "depth", "flow"])
    g.add_argument("--out", default="multi_modality.pdf")
    g.add_argument("--img_size", type=int, default=224)

    c = sub.add_parser("confusion", help="real-class confusion matrix from a "
                       "cli.test --per_task_log JSONL (test.py:115-316 "
                       "analysis path)")
    c.add_argument("--log", required=True, help="per-task JSONL from cli.test")
    c.add_argument("--out", default="confusion.csv")
    c.add_argument("--png", default=None, help="optional heatmap output")
    c.add_argument("--top", type=int, default=10,
                   help="print the N most-confused class pairs")

    m = sub.add_parser("cam", help="Grad-CAM overlay jpg (heatmap_vis.py)")
    m.add_argument("--image", required=True, help="input frame jpg/png")
    m.add_argument("--out", default="cam.jpg")
    m.add_argument("--ckpt", default=None,
                   help="cli.pretrain checkpoint (ActionRecognitionNet "
                        "layout: a checkpoint_<n>.pt or its directory); "
                        "when absent, a random-init trunk is used "
                        "(torchvision's pretrained weights are not "
                        "downloadable offline)")
    m.add_argument("--arch", default="resnet18",
                   choices=["resnet18", "resnet34", "resnet50"])
    m.add_argument("--num_classes", type=int, default=None,
                   help="probe width for the random-init fallback "
                        "(ignored with --ckpt; default 101)")
    m.add_argument("--class_idx", type=int, default=None,
                   help="target class (default: the model's argmax — the "
                        "reference's target_category=None)")
    m.add_argument("--img_size", type=int, default=224)
    m.add_argument("--device", default=None,
                   help="torch device (default: cuda)")

    s = sub.add_parser("skeleton", help="3D skeleton plot (3d_visualization.py)")
    s.add_argument("--npy", required=True, help="(V,3) or (T,V,3) skeleton .npy")
    s.add_argument("--out", default="skeleton.jpg")
    s.add_argument("--frame", type=int, default=0)
    s.add_argument("--clip", action="store_true",
                   help="render every frame of a (T,V,3) clip as a strip")

    args = p.parse_args(argv)
    if args.cmd == "confusion":
        from ..tools.confusion import (read_task_log, confusion_from_records,
                                       per_class_accuracy, most_confused,
                                       write_csv, render_png)
        records = read_task_log(args.log)
        m, ids = confusion_from_records(records)
        write_csv(m, ids, args.out)
        acc = per_class_accuracy(m)
        print(f"{len(records)} tasks, {len(ids)} real classes → {args.out}")
        worst = np.argsort(acc)[:5]
        for i in worst:
            print(f"  class {ids[i]}: acc {acc[i]:.3f} over {int(m[i].sum())}")
        for t, pr, n in most_confused(m, ids, args.top):
            print(f"  {t} → {pr}: {n}×")
        if args.png:
            render_png(m, ids, args.png)
            print(f"heatmap → {args.png}")
        return args.out
    if args.cmd == "cam":
        # heatmap_vis.py:24-49 — read one jpg, Grad-CAM the last trunk stage,
        # write the jet overlay artifact
        from PIL import Image

        from ..utils.saliency import (backbone_grad_cam, backbone_predict,
                                      cam_overlay)
        from .common import resolve_device
        device = resolve_device(args.device)
        img = Image.open(args.image).convert("RGB").resize(
            (args.img_size, args.img_size))
        rgb = np.asarray(img, dtype=np.float32) / 255.0
        net = load_cam_model(args.ckpt, args.arch, args.num_classes, device)
        images = rgb[None]
        cls = args.class_idx
        if cls is None:
            cls = int(np.argmax(backbone_predict(net, images)[0]))
        cam = backbone_grad_cam(net, images, cls)
        Image.fromarray(cam_overlay(cam[0], rgb)).save(args.out)
        print(f"Grad-CAM class {cls} → {args.out}")
        return args.out
    if args.cmd == "grid":
        rows = []
        for r in args.row:
            parts = r.split(":")
            if len(parts) != 3:
                p.error(f"--row must be dataset:class:video, got {r!r}")
            rows.append(tuple(parts))
        out = modality_grid(args.data_root, rows, args.modalities,
                            args.out, args.img_size)
    else:
        pose = np.load(args.npy)
        if pose.ndim not in (2, 3) or pose.shape[-1] != 3:
            p.error(f"--npy must be (V,3) or (T,V,3); got {pose.shape}")
        if args.clip:
            if pose.ndim != 3:
                p.error(f"--clip needs a (T,V,3) clip; got {pose.shape}")
            out = skeleton_clip_grid(pose, args.out)
        else:
            if pose.ndim == 3:
                if not 0 <= args.frame < pose.shape[0]:
                    p.error(f"--frame {args.frame} out of range "
                            f"[0, {pose.shape[0]})")
                pose = pose[args.frame]
            out = draw_skeleton_3d(pose, args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()

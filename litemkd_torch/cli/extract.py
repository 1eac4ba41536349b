"""Feature extraction (port of ``litemkd_tpu/cli/extract.py:29-148``; the
reference's ``extract_feature.py`` and ``extract_multi_feature.py``). Two
modes, each writing a ``<class>/<video>/feature.npy`` tree:

- expert: per-modality per-video trunk features of an
  ``ActionRecognitionNet`` (the ``<modality>`` trees the MFM teacher reads):

    python -m litemkd_torch.cli.extract --mode_extract expert \\
        --arch resnet50 -m PRETRAIN.pt --rgb_path FRAMES \\
        --traintestlist SPLITS --out OUT

  ``-m`` takes a ``.pt`` (the port's or the reference's pretrain
  checkpoint, a run.py expert artifact or a torchvision resnet zoo file;
  the trunk is read) or a checkpoint directory of ``cli.pretrain`` (its
  newest checkpoint); without it the trunk gets random weights from
  ``cfg.train.seed``. The feature width follows the trunk (512, 512, 2048).
- mfm: fused multi-modal features, the tree the student's
  ``teacher_path`` reads:

    python -m litemkd_torch.cli.extract --mode_extract mfm \\
        -m DIR/checkpoint_N.pt --feature_root R --traintestlist R/splits \\
        --out OUT

  ``--fusion`` takes every fusion kind that has an ``extract`` (all but
  ``tsf``); ``--extract_side query`` dumps the query-side fusion of a
  composer preset whose two sides differ. ``-m`` takes a
  ``ThreeTRXShiftLoopTime`` ``.pt`` for ``--fusion mfm`` (the port's
  checkpoint, one that ``export_mfm_checkpoint`` wrote, or the reference's;
  strict) or a checkpoint directory of the port of any kind (its newest
  checkpoint); without it the teacher gets random weights from
  ``cfg.train.seed``.

Runs on cuda unless ``--device`` says otherwise, with TF32 off.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..data import MultiModalFeatureStore, VideoStore
from ..models.student import init_student_
from ..models.teacher import init_mfm_
from ..tools.extract import extract_expert_features, extract_mfm_features
from ..tools.weights import (load_pretrain_init,
                             load_reference_fusion_state_dict, merge_state_dict)
from ..train import CheckpointManager, make_mfm, make_pretrain_model
from .common import (add_common_args, add_device_arg, add_fusion_args,
                     apply_fusion_args, build_config, load_saved_config,
                     resolve_device, set_fp32_math)


def parse(argv=None):
    """(parser, args, cfg)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_fusion_args(p)
    add_device_arg(p)
    p.add_argument("--mode_extract", choices=["expert", "mfm"], required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--test_model_path", "-m", default=None,
                   help="mfm: a ThreeTRXShiftLoopTime .pt (--fusion mfm); "
                        "expert: a "
                        "pretrain, expert or torchvision .pt; or a "
                        "checkpoint directory of the port (random weights "
                        "without it)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--arch", default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50"],
                   help="expert trunk for expert mode (reference "
                        "extract_feature.py --model); feature dim follows "
                        "the trunk (512/512/2048)")
    p.add_argument("--fusion", default="mfm",
                   help="fusion teacher kind for mfm mode: mfm | dga | dga2 | "
                        "two_road | a composer preset | otam:<preset>")
    p.add_argument("--extract_side", choices=["support", "query"],
                   default="support",
                   help="which fusion path side-asymmetric composer presets "
                        "dump (the released classes never defined this; "
                        "side-symmetric teachers reject 'query')")
    args = p.parse_args(argv)
    cfg = build_config(args, base=load_saved_config(args.test_model_path))
    return p, args, apply_fusion_args(cfg, args)


def _newest(path):
    """``path``, or the newest checkpoint of ``path`` when it is a
    checkpoint directory of the port."""
    if path and os.path.isdir(path):
        mgr = CheckpointManager(path)
        return mgr.path(mgr.latest_step())
    return path


def load_expert_trunk(cfg, arch, path, device):
    """An eval-mode ``ActionRecognitionNet`` of ``arch`` on ``device``, its
    trunk read from ``path`` (:func:`load_pretrain_init`; a directory means
    its newest checkpoint) over random weights from ``cfg.train.seed``.
    Extraction reads only the trunk, so the head's width is arbitrary."""
    model = make_pretrain_model(cfg, 2, arch)
    init_student_(model, torch.Generator().manual_seed(cfg.train.seed))
    path = _newest(path)
    if path:
        model.load_state_dict(merge_state_dict(model.state_dict(),
                                               load_pretrain_init(path, arch)),
                              strict=True)
    return model.to(device).eval()


def load_mfm(cfg, kind, path, device):
    """An eval-mode fusion teacher of ``kind`` (:func:`make_mfm`) on
    ``device``: from a ``.pt`` file (strict, through
    :func:`load_reference_fusion_state_dict`), from the newest checkpoint
    of a directory, or with random weights from ``cfg.train.seed``."""
    model = make_mfm(cfg, kind)
    path = _newest(path)
    if path:
        model.load_state_dict(load_reference_fusion_state_dict(path, cfg, kind),
                              strict=True)
    else:
        init_mfm_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device).eval()


def main(argv=None):
    p, args, cfg = parse(argv)
    if args.mode_extract == "expert":
        if not cfg.data.rgb_path:
            p.error("expert extraction reads a frame tree: pass --rgb_path "
                    "(the synthetic dataset has none)")
        device = resolve_device(args.device)
        set_fp32_math()
        vs = VideoStore(cfg.data.rgb_path, cfg.data.traintestlist,
                        cfg.data.split, cfg.episode.seq_len, cfg.episode.img_size)
        model = load_expert_trunk(cfg, args.arch, args.test_model_path, device)
        if args.test_model_path:
            print(f"loaded {args.arch} trunk {args.test_model_path}")
        n = extract_expert_features(vs, model, args.out,
                                    batch_size=args.batch_size)
        print(f"extracted {n} videos → {args.out}")
        return n
    if not args.feature_root:
        p.error("mfm extraction reads per-modality feature trees: pass "
                "--feature_root")
    path = args.test_model_path
    if path and path.endswith((".pt", ".pth")) and args.fusion != "mfm":
        p.error("torch checkpoint import supports --fusion mfm only "
                "(the reference trains ThreeTRXShiftLoopTime)")
    device = resolve_device(args.device)
    set_fp32_math()
    model = load_mfm(cfg, args.fusion, args.test_model_path, device)
    paths = {m: os.path.join(args.feature_root, m)
             for m in cfg.model.modalities}
    store = MultiModalFeatureStore(paths, cfg.data.traintestlist,
                                   cfg.data.split, cfg.episode.seq_len,
                                   cfg.model.trans_linear_in_dim)
    if args.test_model_path:
        print(f"loaded {args.fusion} teacher {args.test_model_path}")
    n = extract_mfm_features(store, model, args.out,
                             batch_size=args.batch_size,
                             fusion_kind=args.fusion,
                             side=int(args.extract_side == "query"))
    print(f"extracted {n} fused videos → {args.out}")
    return n


if __name__ == "__main__":
    main()

"""Fused-feature extraction (port of the ``--mode_extract mfm`` part of
``litemkd_tpu/cli/extract.py:29-148``; the reference's
``extract_multi_feature.py``): writes the ``<class>/<video>/feature.npy``
tree that the student's ``teacher_path`` reads.

    python -m litemkd_torch.cli.extract --mode_extract mfm \\
        -m DIR/checkpoint_N.pt --feature_root R --traintestlist R/splits \\
        --out OUT

``-m`` takes a ``ThreeTRXShiftLoopTime`` ``.pt`` (the port's checkpoint,
one that ``export_mfm_checkpoint`` wrote, or the reference's; strict) or a
checkpoint directory of the port (its newest checkpoint); without it the
teacher gets random weights from ``cfg.train.seed``. Runs on cuda unless
``--device`` says otherwise, in fp32 with TF32 off. Expert extraction is not
ported yet.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..data import MultiModalFeatureStore
from ..models.teacher import init_mfm_
from ..tools.extract import extract_mfm_features
from ..tools.weights import load_reference_mfm_state_dict
from ..train import CheckpointManager, make_mfm
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
                   help="ThreeTRXShiftLoopTime .pt or a checkpoint directory "
                        "of the port (random weights without it)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--fusion", default="mfm",
                   help="fusion teacher kind; the port has mfm")
    args = p.parse_args(argv)
    cfg = build_config(args, base=load_saved_config(args.test_model_path))
    return p, args, apply_fusion_args(cfg, args)


def load_mfm(cfg, kind, path, device):
    """An eval-mode fusion teacher of ``kind`` (:func:`make_mfm`) on
    ``device``: from a ``.pt`` file (strict, with the geometry guards), from
    the newest checkpoint of a directory, or with random weights from
    ``cfg.train.seed``."""
    model = make_mfm(cfg, kind)
    if path and os.path.isdir(path):
        mgr = CheckpointManager(path)
        path = mgr.path(mgr.latest_step())
    if path:
        model.load_state_dict(load_reference_mfm_state_dict(path, cfg),
                              strict=True)
    else:
        init_mfm_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(device).eval()


def main(argv=None):
    p, args, cfg = parse(argv)
    if args.mode_extract == "expert":
        raise NotImplementedError(
            "expert extraction is not ported yet (ROADMAP queue 5: the "
            "expert and pretrain stages)")
    if not args.feature_root:
        p.error("mfm extraction reads per-modality feature trees: pass "
                "--feature_root")
    device = resolve_device(args.device)
    set_fp32_math()
    model = load_mfm(cfg, args.fusion, args.test_model_path, device)
    paths = {m: os.path.join(args.feature_root, m)
             for m in cfg.model.modalities}
    store = MultiModalFeatureStore(paths, cfg.data.traintestlist,
                                   cfg.data.split, cfg.episode.seq_len,
                                   cfg.model.trans_linear_in_dim)
    if args.test_model_path:
        print(f"loaded MFM teacher {args.test_model_path}")
    n = extract_mfm_features(store, model, args.out,
                             batch_size=args.batch_size)
    print(f"extracted {n} fused videos → {args.out}")
    return n


if __name__ == "__main__":
    main()

"""Export a checkpoint of the port to a reference-format torch ``.pt`` file,
or to an AOT serving artifact (port of ``litemkd_tpu/cli/export.py``).

    # student (backbone + classifier) → model_select.load_student layout
    python -m litemkd_torch.cli.export --ckpt RUN/checkpoint_N.pt --out student.pt

    # teacher head → load_teacher layout (bracnch.transformers.0.*)
    python -m litemkd_torch.cli.export --ckpt RUN/checkpoint_N.pt --out teacher.pt --teacher

    # MFM fusion teacher → ThreeTRXShiftLoopTime layout (runs in the reference)
    python -m litemkd_torch.cli.export --ckpt MFM/checkpoint_N.pt --out mfm.pt --mfm

    # AOT serving artifact (a torch.export program, weights and a manifest
    # in one file; a serving host runs it with the port's ops and no model
    # code), traced on --device
    python -m litemkd_torch.cli.export --ckpt RUN/checkpoint_N.pt \\
        --out model.litemkd --aot [--aot_episodes 1] [--aot_check]

    # AOT fused-feature extractor (the MFM teacher's extraction path)
    python -m litemkd_torch.cli.export --ckpt MFM/checkpoint_N.pt \\
        --out extract.litemkd --aot --mfm [--aot_batch 8] [--aot_check]

``--ckpt`` takes a checkpoint ``.pt`` of the port (``checkpoint_<n>.pt``,
with the run's ``config.json`` beside it, which gives the geometry) or a
run directory (its newest checkpoint); a reference-layout ``.pt`` loads
too. Runs on cuda unless ``--device`` says otherwise (only ``--aot`` runs a
model), with TF32 off.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops.dtypes import set_fp32_math
from ..tools.weights import (load_reference_checkpoint, mfm_export_state_dict,
                             save_reference_checkpoint, student_export_state_dict,
                             teacher_export_state_dict)
from .common import (add_common_args, add_device_arg, build_config,
                     load_saved_config, resolve_device)


def checkpoint_file(path: str) -> str:
    """``path``, or a run directory's newest ``checkpoint_<n>.pt``."""
    if not os.path.isdir(path):
        return path
    from ..train.checkpoint import CheckpointManager
    mgr = CheckpointManager(path)
    if mgr.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint_<n>.pt in {path}")
    return mgr.path(mgr.latest_step())


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_device_arg(p)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint .pt of the port (config.json beside it) "
                        "or a run directory")
    p.add_argument("--out", required=True, help="output .pt or .litemkd path")
    p.add_argument("--teacher", action="store_true",
                   help="export the teacher-head layout instead of a student")
    p.add_argument("--mfm", action="store_true",
                   help="export an MFM fusion-teacher checkpoint to the "
                        "ThreeTRXShiftLoopTime layout")
    p.add_argument("--aot", action="store_true",
                   help="emit a torch.export serving artifact instead of a "
                        "torch checkpoint")
    p.add_argument("--aot_platforms", default=None,
                   help="accepted so that the JAX package's command lines "
                        "parse; the artifact is traced on --device")
    p.add_argument("--aot_episodes", type=int, default=1,
                   help="episode batch size baked into the artifact")
    p.add_argument("--aot_batch", type=int, default=8,
                   help="video batch size for --aot --mfm extract artifacts")
    p.add_argument("--aot_check", action="store_true",
                   help="reload the artifact and score a seeded episode (or "
                        "fuse a seeded feature batch) as a smoke test")
    args = p.parse_args(argv)
    args.ckpt = checkpoint_file(args.ckpt)
    # the run config saved next to the checkpoint is the base: exporting a
    # non-default-geometry run (e.g. --preset tiny) needs no re-specified flags
    return args, build_config(args, base=load_saved_config(args.ckpt))


def _aot(args, cfg, sd):
    from ..tools.aot import (export_extract_artifact, export_serving_artifact,
                             load_serving_artifact)
    device = resolve_device(args.device)
    set_fp32_math()
    rng = np.random.default_rng(0)
    if args.mfm:
        from ..train.teacher_steps import make_mfm
        with torch.device(device):   # the 551 M-parameter MFM: no CPU init
            model = make_mfm(cfg)
        model.load_state_dict(sd, strict=True)
        manifest = export_extract_artifact(cfg, model, args.out, device,
                                           batch=args.aot_batch)
        print(f"wrote AOT extract artifact → {args.out} "
              f"(platforms={manifest['platforms']}, "
              f"modalities={manifest['modalities']}, "
              f"batch={manifest['batch']})")
        if args.aot_check:
            extractor, m = load_serving_artifact(args.out)
            feats = {mod: torch.from_numpy(rng.standard_normal(sh).astype(
                np.float32)).to(m["device"])
                for mod, sh in m["input_shapes"].items()}
            fused = extractor(feats)
            if not torch.isfinite(fused).all():
                raise AssertionError("the extract artifact fused non-finite values")
            print(f"smoke check OK: fused {tuple(fused.shape)}")
        return manifest
    from ..models import BatchedStudent
    model = BatchedStudent(cfg)
    model.load_state_dict(sd, strict=True)
    manifest = export_serving_artifact(cfg, model, args.out, device,
                                       episodes=args.aot_episodes)
    print(f"wrote AOT artifact → {args.out} "
          f"(platforms={manifest['platforms']}, "
          f"{manifest['way']}-way {manifest['shot']}-shot)")
    if args.aot_check:
        scorer, m = load_serving_artifact(args.out)
        sh, dev = m["input_shapes"], m["device"]
        labels = np.tile(np.arange(m["way"]), (m["episodes"], m["shot"]))
        logits = scorer(
            torch.from_numpy(rng.integers(0, 255, sh["support_clips"],
                                          dtype=np.uint8)).to(dev),
            torch.from_numpy(labels[:, :sh["support_labels"][1]]).to(
                dev, getattr(torch, m["input_dtypes"]["support_labels"])),
            torch.from_numpy(rng.integers(0, 255, sh["query_clips"],
                                          dtype=np.uint8)).to(dev))
        if not torch.isfinite(logits).all():
            raise AssertionError("the scorer artifact gave non-finite logits")
        print(f"smoke check OK: logits {tuple(logits.shape)}")
    return manifest


def main(argv=None):
    """Returns the exported state dict, or the artifact's manifest."""
    args, cfg = parse(argv)
    sd, it = load_reference_checkpoint(args.ckpt)
    if args.mfm:
        sd = mfm_export_state_dict(sd, cfg)
    elif args.teacher and not args.aot:
        sd = teacher_export_state_dict(sd)
    else:
        sd = student_export_state_dict(sd, cfg)
    if args.aot:
        return _aot(args, cfg, sd)
    save_reference_checkpoint(sd, args.out, iteration=it)
    print(f"wrote {len(sd)} tensors → {args.out}")
    return sd


if __name__ == "__main__":
    main()

"""Shared CLI plumbing of the port: the flags that its eval and training
paths read, copied from ``litemkd_tpu/cli/common.py:67-324`` (same names,
same mapping onto the typed Config), plus ``--device`` and the sampler and
device choice. Flags of paths the port does not have yet (real video data,
meshes, teacher eval) come with those paths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import torch

from ..config import Config, preset


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The shared flags that the port's eval path reads, with the JAX
    package's names and meanings."""
    p.add_argument("--preset", default=None,
                   help="named preset (student_fc2sup_dist, student_plain, "
                        "mfm_teacher, student_mobilenet, expert_trx, "
                        "expert_strm, expert_baseline, expert_skeleton_trx, "
                        "tiny)")
    # episode geometry (options.py:12-25)
    p.add_argument("--way", type=int, default=None)
    p.add_argument("--shot", type=int, default=None)
    p.add_argument("--query_per_class", type=int, default=None)
    p.add_argument("--query_per_class_test", type=int, default=None)
    p.add_argument("--seq_len", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None)
    # model selection (options.py:35-45)
    p.add_argument("--model_backbone", default=None)
    p.add_argument("--model_classifier", default=None)
    p.add_argument("--model_teacher", default=None)
    p.add_argument("--trans_linear_in_dim", type=int, default=None)
    p.add_argument("--trans_linear_out_dim", type=int, default=None)
    p.add_argument("--temp_set", nargs="+", type=int, default=None)
    p.add_argument("--trans_dropout", type=float, default=None)
    p.add_argument("--pallas_bn", action="store_true", default=None,
                   help="BN training moments from the port's BN-moment CUDA "
                        "kernels (model.pallas_bn; cuDNN otherwise)")
    p.add_argument("--freeze_bn", action="store_true", default=None,
                   help="BN uses running stats during training (finetune "
                        "mode)")
    # distillation (options.py:40, 48-60); the name also picks the logit
    # merge rule
    p.add_argument("--distill_name", default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--soft_loss_weight", type=float, default=None)
    p.add_argument("--hard_loss_weight", type=float, default=None)
    # data (options.py:28)
    p.add_argument("--dataset",
                   choices=["ssv2", "kinetics", "hmdb", "ucf", "synthetic"],
                   default=None)
    p.add_argument("--synthetic_noise", type=float, default=None,
                   help="synthetic-dataset difficulty (noise scale around "
                        "the class prototypes; default 0.3)")
    p.add_argument("--mode", default=None, help="experiment description tag")
    p.add_argument("--num_test_tasks", type=int, default=None)


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's training flags (options.py:64-76), plus
    ``--debug``."""
    p.add_argument("--checkpoint_dir", "-c", default=None)
    p.add_argument("--training_iterations", "-i", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", "-r", action="store_true")
    p.add_argument("--test_iters", nargs="+", type=int, default=None)
    p.add_argument("--learning_rate", "-lr", type=float, default=None)
    p.add_argument("--opt", choices=["adam", "sgd"], default=None)
    p.add_argument("--tasks_per_batch", type=int, default=None)
    p.add_argument("--micro_batch", type=int, default=None,
                   help="episodes per fwd/bwd chunk (grad accumulation)")
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--print_freq", type=int, default=None)
    p.add_argument("--sch", nargs="+", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--teacher_checkpoint", default=None,
                   help="reference-layout teacher .pt (bracnch.transformers.0.*)")
    p.add_argument("--watch", action="store_true", default=None,
                   help="log global and per-module gradient/parameter norms "
                        "with the step metrics")
    p.add_argument("--debug", action="store_true",
                   help="no checkpoints, no log files")


def add_test_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--test_model_path", "-m", default=None,
                   help="reference-layout student .pt (strict load)")


def load_saved_config(*candidates: Optional[str]) -> Optional[Config]:
    """The config ``save_run_config`` recorded next to a checkpoint, to use
    as the base for eval/export CLIs — a checkpoint then carries its own
    geometry (way/dims/backbone) instead of requiring every flag to be
    re-specified (reference analog: args.pkl, multi_fusion.py:369-371).
    Accepts checkpoint dirs or file paths (the containing dir is searched);
    returns None when no record exists (e.g. a reference .pt file)."""
    for p in candidates:
        if not p:
            continue
        d = p if os.path.isdir(p) else os.path.dirname(p)
        f = os.path.join(d, "config.json")
        if os.path.exists(f):
            with open(f) as fh:
                cfg = Config.from_dict(json.load(fh))
            # the record's checkpoint_dir names the ORIGINAL training run;
            # an eval/export CLI must never write (or refuse to start) there
            return cfg.replace(train=dataclasses.replace(
                cfg.train, checkpoint_dir=None,
                resume_from_checkpoint=False))
    return None


def build_config(args: argparse.Namespace,
                 base: Optional[Config] = None) -> Config:
    """The preset (or ``base``, or the defaults) with the given flags on top,
    as the JAX package's ``build_config`` maps them."""
    cfg = preset(args.preset) if args.preset else (base or Config())

    def pick(current, val):
        return current if val is None else val

    ep = cfg.episode
    cfg = cfg.replace(episode=dataclasses.replace(
        ep, way=pick(ep.way, args.way), shot=pick(ep.shot, args.shot),
        query_per_class=pick(ep.query_per_class, args.query_per_class),
        query_per_class_test=pick(ep.query_per_class_test,
                                  args.query_per_class_test),
        seq_len=pick(ep.seq_len, args.seq_len),
        img_size=pick(ep.img_size, args.img_size)))
    m = cfg.model
    cfg = cfg.replace(model=dataclasses.replace(
        m, backbone=pick(m.backbone, args.model_backbone),
        classifier=pick(m.classifier, args.model_classifier),
        teacher=pick(m.teacher, args.model_teacher),
        trans_linear_in_dim=pick(m.trans_linear_in_dim, args.trans_linear_in_dim),
        trans_linear_out_dim=pick(m.trans_linear_out_dim,
                                  args.trans_linear_out_dim),
        temp_set=tuple(args.temp_set) if args.temp_set else m.temp_set,
        trans_dropout=pick(m.trans_dropout, args.trans_dropout),
        pallas_bn=pick(m.pallas_bn, args.pallas_bn),
        freeze_bn=pick(m.freeze_bn, args.freeze_bn)))
    d = cfg.distill
    cfg = cfg.replace(distill=dataclasses.replace(
        d, name=pick(d.name, args.distill_name),
        temperature=pick(d.temperature, args.temperature),
        soft_loss_weight=pick(d.soft_loss_weight, args.soft_loss_weight),
        hard_loss_weight=pick(d.hard_loss_weight, args.hard_loss_weight)))
    dc = cfg.data
    cfg = cfg.replace(data=dataclasses.replace(
        dc, dataset=pick(dc.dataset, args.dataset),
        synthetic_noise=pick(dc.synthetic_noise, args.synthetic_noise)))
    if args.mode:
        cfg = cfg.replace(mode=args.mode)
    t = cfg.train
    if not hasattr(args, "learning_rate"):      # eval flags only
        return cfg.replace(train=dataclasses.replace(
            t, num_test_tasks=pick(t.num_test_tasks, args.num_test_tasks)))
    return cfg.replace(train=dataclasses.replace(
        t,
        tasks_per_batch=pick(t.tasks_per_batch, args.tasks_per_batch),
        micro_batch=pick(t.micro_batch, args.micro_batch),
        training_iterations=pick(t.training_iterations,
                                 args.training_iterations),
        learning_rate=pick(t.learning_rate, args.learning_rate),
        optimizer=pick(t.optimizer, args.opt),
        sch=tuple(args.sch) if args.sch else t.sch,
        save_freq=pick(t.save_freq, args.save_freq),
        print_freq=pick(t.print_freq, args.print_freq),
        test_iters=tuple(args.test_iters) if args.test_iters else t.test_iters,
        num_test_tasks=pick(t.num_test_tasks, args.num_test_tasks),
        seed=pick(t.seed, args.seed),
        checkpoint_dir=None if args.debug else pick(t.checkpoint_dir,
                                                    args.checkpoint_dir),
        resume_from_checkpoint=bool(args.resume_from_checkpoint),
        watch=pick(t.watch, args.watch)))


def save_run_config(cfg: Config) -> None:
    """Write the run config next to the checkpoints (the reference's
    args.pkl); a resume keeps the original run's record."""
    if not cfg.train.checkpoint_dir:
        return
    path = os.path.join(cfg.train.checkpoint_dir, "config.json")
    if cfg.train.resume_from_checkpoint and os.path.exists(path):
        return
    os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(cfg.to_json())


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda; cpu runs "
                        "every kernel's plain PyTorch version)")


def resolve_device(device=None) -> torch.device:
    """The requested device (a name or ``torch.device``), or ``cuda`` when
    none was given. Raises when CUDA is asked for (explicitly or by
    default) and is not available."""
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return device


def set_fp32_math() -> None:
    """Full fp32 in matrix products and convolutions (no TF32), so fp32
    results match the JAX package's highest-precision reference. The entry
    points call this; bf16 trunks are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_sampler(cfg: Config, need_teacher: bool = True):
    """Construct the episode sampler for the configured dataset. Only the
    synthetic source is ported; real video trees need the native clip
    decoder, which the port does not have yet."""
    if cfg.data.dataset != "synthetic":
        raise NotImplementedError(
            f"dataset {cfg.data.dataset!r}: the port reads only "
            "--dataset synthetic so far")
    from ..data import SyntheticEpisodeSource
    return SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                  noise=cfg.data.synthetic_noise,
                                  with_teacher_feats=need_teacher)

"""Shared CLI plumbing of the port: the flags that its eval, training,
MFM-teacher and extraction paths read, copied from
``litemkd_tpu/cli/common.py:67-378`` and the JAX package's
``train_teacher``/``extract``/``pretrain`` CLIs (same names, same mapping
onto the typed Config), plus ``--device``, the sampler, fixed-episode
files and the device choice. Flags of paths the port does not have yet
(meshes) come with those paths. ``--pallas_tct`` sets ``model.use_pallas``
and nothing else (a CUDA tensor always launches the TCT kernel);
``--wandb`` reaches the training CLIs' :class:`MetricsLogger`.
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
    p.add_argument("--pallas_tct", action="store_true", default=None,
                   help="model.use_pallas, as in the JAX package; the port "
                        "launches its TCT kernel on every CUDA tensor "
                        "whatever it says")
    p.add_argument("--pallas_bn", action="store_true", default=None,
                   help="BN training moments from the port's BN-moment CUDA "
                        "kernels (model.pallas_bn; cuDNN otherwise)")
    p.add_argument("--freeze_bn", action="store_true", default=None,
                   help="BN uses running stats during training (finetune "
                        "mode)")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute each residual block's forward in the "
                        "backward pass (activation memory for trunk time)")
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
    p.add_argument("--split", type=int, default=None)
    p.add_argument("--traintestlist", default=None)
    p.add_argument("--rgb_path", "--RGB_path", dest="rgb_path", default=None,
                   help="frame tree <class>/<video>/<frame>.jpg (or a .zip)")
    p.add_argument("--teacher_path", default=None,
                   help="fused teacher feature tree "
                        "<class>/<video>/feature.npy")
    p.add_argument("--num_workers", type=int, default=None,
                   help="threads that load the clips of an episode")
    p.add_argument("--fixed_episode_file", default=None,
                   help="replay the test episodes of this file "
                        "(cli.gen_fixed_split, or the reference's "
                        "fixed_test JSON/YAML)")
    p.add_argument("--synthetic_noise", type=float, default=None,
                   help="synthetic-dataset difficulty (noise scale around "
                        "the class prototypes; default 0.3)")
    # multi-camera datasets (reference run.py:142-146)
    p.add_argument("--cross_view", action="store_true", default=None,
                   help="support clips from a random camera view, queries "
                        "from --view")
    p.add_argument("--view", type=int, default=None,
                   help="query camera index into sorted(view_root) for "
                        "--cross_view")
    p.add_argument("--fixed_view", default=None,
                   help="pin every clip to one named camera view")
    p.add_argument("--view_root", default=None,
                   help="all_view_rgb_l8-style tree (default: sibling of "
                        "rgb_path)")
    p.add_argument("--mode", default=None, help="experiment description tag")
    p.add_argument("--num_test_tasks", type=int, default=None)
    p.add_argument("--wandb", action="store_true",
                   help="mirror metrics to wandb (reference trainwandb.py; "
                        "skipped with a notice if the package is missing)")


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


def add_pretrain_args(p: argparse.ArgumentParser) -> None:
    """The supervised pretraining flags (``litemkd_tpu/cli/pretrain.py:26-40``),
    with the JAX package's defaults."""
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr_1", type=float, default=0.000001,
                   help="trunk SGD learning rate (pretrain.py:31,84)")
    p.add_argument("--lr_2", type=float, default=0.01,
                   help="classifier-head SGD learning rate (pretrain.py:32,85)")
    p.add_argument("--arch", default="resnet50",
                   help="resnet18|resnet34|resnet50 (Action_Recognition_"
                        "Resnet50) or deit_small (model_distillation's ViT)")
    p.add_argument("--init_checkpoint", default=None,
                   help="warm-start the trunk from a torchvision resnet zoo "
                        "file, a pretrain (convnet.*) or expert (resnet.*) "
                        ".pt, or a trunk.* file; for deit_small a timm DeiT "
                        "file or a deit pretrain checkpoint")


def add_fusion_args(p: argparse.ArgumentParser) -> None:
    """The MFM teacher's flags (``litemkd_tpu/cli/train_teacher.py`` and
    ``cli/extract.py``): per-modality feature trees and the fusion's
    geometry."""
    p.add_argument("--feature_root", default=None,
                   help="dir containing per-modality feature trees "
                        "(<root>/<modality>/<class>/<video>/feature.npy)")
    p.add_argument("--modalities", nargs="+", default=None,
                   help="modality names, m1 first (default rgb depth flow)")
    p.add_argument("--trans_num", type=int, default=None,
                   help="fusion encoder depth")
    p.add_argument("--shirt_num", type=int, default=None,
                   help="circular time shift of modality 2 (and 3+)")


def apply_fusion_args(cfg: Config, args: argparse.Namespace) -> Config:
    """``--modalities``, ``--trans_num`` and ``--shirt_num`` on top of
    ``cfg``, as the JAX package's teacher CLIs apply them."""
    m = cfg.model
    return cfg.replace(model=dataclasses.replace(
        m, trans_num=m.trans_num if args.trans_num is None else args.trans_num,
        shirt_num=m.shirt_num if args.shirt_num is None else args.shirt_num,
        modalities=tuple(args.modalities) if args.modalities
        else m.modalities))


def add_test_args(p: argparse.ArgumentParser) -> None:
    """The eval CLI's flags (``litemkd_tpu/cli/common.py:164-170``)."""
    p.add_argument("--test_model_path", "-m", default=None,
                   help="reference-layout student .pt (strict load), or a "
                        "teacher .pt with --test_model teacher")
    p.add_argument("--test_model", choices=["teacher", "student"],
                   default="student")
    p.add_argument("--per_task_log", default=None, metavar="PATH",
                   help="write one JSON line per task (accuracy, episode "
                        "classes, real-class labels/predictions): the "
                        "reference's per-task analysis stream (test.py:232, "
                        "utils.py task_confusion)")


def dataset_paths(dataset: str, root: str = "data") -> dict:
    """The reference's per-dataset path table (options.py:126-159),
    normalised to <root>/<dataset>/{splits,l8/rgb_l8,feature/multi_feature},
    as the JAX package fills it in."""
    table = {
        "kinetics": ("kinetics", "kinetics/splits/kineticsTrainTestlist"),
        "ucf": ("ucf101", "ucf101/splits/ucf_ARN"),
        "hmdb": ("hmdb", "hmdb/splits/hmdb_ARN"),
        "ssv2": ("ssv2", "ssv2/splits/somethingsomethingv2TrainTestlist"),
    }
    if dataset == "synthetic":
        return dict(traintestlist=None, rgb_path=None, teacher_path=None)
    folder, splits = table[dataset]
    return dict(traintestlist=os.path.join(root, splits),
                rgb_path=os.path.join(root, folder, "l8/rgb_l8"),
                teacher_path=os.path.join(root, folder, "feature/multi_feature"))


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
        freeze_bn=pick(m.freeze_bn, args.freeze_bn),
        remat=pick(m.remat, args.remat),
        use_pallas=pick(m.use_pallas, args.pallas_tct)))
    d = cfg.distill
    cfg = cfg.replace(distill=dataclasses.replace(
        d, name=pick(d.name, args.distill_name),
        temperature=pick(d.temperature, args.temperature),
        soft_loss_weight=pick(d.soft_loss_weight, args.soft_loss_weight),
        hard_loss_weight=pick(d.hard_loss_weight, args.hard_loss_weight)))
    dc = cfg.data
    dataset = pick(dc.dataset, args.dataset)
    paths = dataset_paths(dataset)
    cfg = cfg.replace(data=dataclasses.replace(
        dc, dataset=dataset, split=pick(dc.split, args.split),
        traintestlist=(args.traintestlist or dc.traintestlist
                       or paths["traintestlist"]),
        rgb_path=args.rgb_path or dc.rgb_path or paths["rgb_path"],
        teacher_path=(args.teacher_path or dc.teacher_path
                      or paths["teacher_path"]),
        num_workers=pick(dc.num_workers, args.num_workers),
        fixed_episode_file=pick(dc.fixed_episode_file,
                                args.fixed_episode_file),
        synthetic_noise=pick(dc.synthetic_noise, args.synthetic_noise),
        cross_view=pick(dc.cross_view, args.cross_view),
        query_view=pick(dc.query_view, args.view),
        fixed_view=pick(dc.fixed_view, args.fixed_view),
        view_root=pick(dc.view_root, args.view_root)))
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


def episode_index(sampler, train: bool = False):
    """The split index behind any sampler: video-backed (``videos``),
    feature-backed (``features``), multi-modal (``store``), or synthetic
    (its nominal ``split()``, keyed on (class, video index), so that fixed
    episodes replay exactly)."""
    store = (getattr(sampler, "videos", None)
             or getattr(sampler, "features", None)
             or getattr(sampler, "store", None))
    return (store if store is not None else sampler).split(train)


def load_fixed_specs(cfg: Config, sampler):
    """The episodes of ``cfg.data.fixed_episode_file`` (None without one):
    a native JSON file of ``cli.gen_fixed_split``, or the reference's
    ``fixed_test`` schema (YAML, or JSON that is not the native form),
    converted against the sampler's test index."""
    path = cfg.data.fixed_episode_file
    if not path:
        return None
    from ..data import load_fixed_episodes, load_reference_fixed_episodes
    if path.endswith((".yaml", ".yml")):
        specs = load_reference_fixed_episodes(path, episode_index(sampler))
    else:
        try:
            specs = load_fixed_episodes(path)
        except (KeyError, TypeError, AttributeError):
            specs = load_reference_fixed_episodes(path, episode_index(sampler))
    print(f"replaying {len(specs)} fixed episodes")
    return specs


def build_sampler(cfg: Config, need_teacher: bool = True):
    """The episode sampler of the configured dataset: the synthetic source,
    or an :class:`EpisodeSampler` over the frame tree ``rgb_path`` (with a
    multi-view tree for ``cross_view``/``fixed_view``, by default the
    ``all_view_rgb_l8`` sibling of ``rgb_path``) and, with
    ``need_teacher``, the fused feature tree ``teacher_path``."""
    if cfg.data.dataset == "synthetic":
        from ..data import SyntheticEpisodeSource
        return SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                      noise=cfg.data.synthetic_noise,
                                      with_teacher_feats=need_teacher)
    from ..data import EpisodeSampler, FeatureStore, VideoStore
    video_store = feature_store = None
    if cfg.data.rgb_path:
        view_root = cfg.data.view_root
        if view_root is None and (cfg.data.cross_view or cfg.data.fixed_view):
            # the reference's derivation (video_reader.py:265)
            view_root = os.path.join(os.path.dirname(
                cfg.data.rgb_path.rstrip("/")), "all_view_rgb_l8")
        video_store = VideoStore(cfg.data.rgb_path, cfg.data.traintestlist,
                                 cfg.data.split, cfg.episode.seq_len,
                                 cfg.episode.img_size, view_root=view_root)
    if need_teacher and cfg.data.teacher_path:
        feature_store = FeatureStore(cfg.data.teacher_path,
                                     cfg.data.traintestlist, cfg.data.split,
                                     cfg.episode.seq_len,
                                     cfg.model.trans_linear_in_dim)
    return EpisodeSampler(cfg, video_store, feature_store,
                          num_workers=cfg.data.num_workers)

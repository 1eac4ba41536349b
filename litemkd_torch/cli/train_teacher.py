"""Fusion-teacher training and evaluation (port of
``litemkd_tpu/cli/train_teacher.py:76-287``; the reference's
``multi_fusion.py --model <Class>`` and ``score_fusion_run.py``):

    python -m litemkd_torch.cli.train_teacher --preset mfm_teacher \\
        --feature_root R --traintestlist R/splits -c DIR
    python -m litemkd_torch.cli.train_teacher --test_only -m DIR/checkpoint_N.pt \\
        --feature_root R --traintestlist R/splits
    python -m litemkd_torch.cli.train_teacher --preset tiny --dataset synthetic \\
        --device cpu -c /tmp/ck [--fusion ThreeCross]
    python -m litemkd_torch.cli.train_teacher --fusion tsf --score_weights 1 0.5 0.5 \\
        --branch_ckpt rgb=EXPERT_RUN_DIR ...

``--feature_root`` holds one feature tree per modality,
``<root>/<modality>/<class>/<video>/feature.npy``. ``--fusion`` takes every
kind of the JAX package: ``mfm`` (``ThreeTRXShiftLoopTime``, the default),
``tsf``, ``dga``, ``dga2``, ``two_road``, ``two_road_videoaxis``, a composer
preset or ``otam:<preset>``. ``--branch_ckpt MODALITY=PATH`` grafts an
expert's head (a run.py ``.pt`` or a run directory of the port) into a TSF
branch. ``-m`` takes a reference ``.pt`` of the kind's class (or the
port's own checkpoint), loaded strictly, or a checkpoint directory of the
port, whose newest checkpoint is restored whole; training then continues
from it, or ``--test_only`` evaluates it (replaying
``--fixed_episode_file`` where one is given; pass the run's ``--fusion``
again). Runs on cuda unless ``--device`` says otherwise, in fp32 with TF32
off. Checkpoints and ``config.json`` go to ``-c``. Under ``torchrun`` the
training is data-parallel over ``--mesh_data`` replicas (each draws its
share of every batch, the gradients are summed over them; rank 0 writes)
and tensor-parallel over the ``--mesh_model`` ranks of a replica (the
encoders' attention and MLP, the stream fusions' ``f1`` and the TCT's k/v
maps cut over them), and the eval is sharded alike:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m litemkd_torch.cli.train_teacher --preset mfm_teacher \
        --mesh_data 1 --mesh_model 2 --feature_root R ... -c DIR
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.synthetic import SyntheticEpisodeSource
from ..ops.dtypes import set_fp32_math
from ..parallel import shutdown
from ..tools.weights import load_reference_fusion_state_dict
from ..train import (CheckpointManager, EpisodeBatch, create_mfm_train_state,
                     make_mfm_eval_step, make_mfm_train_step, run_eval,
                     shard_train_state, train_loop, verify_checkpoint_dir)
from ..train.teacher_steps import load_tsf_branches
from ..utils.logging import MetricsLogger
from .common import (add_common_args, add_device_arg, add_fusion_args,
                     add_train_args, apply_fusion_args, build_config,
                     load_fixed_specs, load_saved_config, save_run_config,
                     setup_data_parallel)


class SyntheticMultiModalSource:
    """In-memory multi-modal feature episodes for smoke runs and tests
    (``litemkd_tpu/cli/train_teacher.py:25-59``): one
    :class:`SyntheticEpisodeSource` per modality (seed + i), all drawing
    the same episode geometry from one seed a batch. Each source draws its
    frames too and they are thrown away, so one seed gives the JAX
    package's batches. ``specs`` go to every source, so that fixed
    episodes replay in every modality."""

    def __init__(self, cfg, n_classes=16, seed=0, noise=0.3):
        self.cfg = cfg
        self.sources = {m: SyntheticEpisodeSource(
            cfg, n_classes=n_classes, seed=seed + i, noise=noise,
            with_teacher_feats=True)
            for i, m in enumerate(cfg.model.modalities)}

    def split(self, train: bool = False):
        """The nominal index that every modality's source shares."""
        return next(iter(self.sources.values())).split(train)

    def sample_batch(self, rng, n_episodes, train=True,
                     specs=None) -> EpisodeBatch:
        seed = int(rng.integers(0, 2 ** 31))
        batches = {m: s.sample_batch(np.random.default_rng(seed), n_episodes,
                                     train=train, specs=specs)
                   for m, s in self.sources.items()}
        first = next(iter(batches.values()))
        return EpisodeBatch(
            support_clips={m: b.support_feats for m, b in batches.items()},
            support_labels=first.support_labels,
            query_clips={m: b.query_feats for m, b in batches.items()},
            query_labels=first.query_labels)


def build_mm_sampler(cfg, feature_root):
    """The synthetic source (at its default noise, as the JAX package
    builds it), or the episode sampler over the per-modality feature trees
    under ``feature_root``."""
    if cfg.data.dataset == "synthetic":
        return SyntheticMultiModalSource(cfg, seed=cfg.train.seed)
    from ..data import MultiModalEpisodeSampler, MultiModalFeatureStore
    paths = {m: os.path.join(feature_root, m) for m in cfg.model.modalities}
    store = MultiModalFeatureStore(paths, cfg.data.traintestlist,
                                   cfg.data.split, cfg.episode.seq_len,
                                   cfg.model.trans_linear_in_dim)
    return MultiModalEpisodeSampler(cfg, store)


def parse(argv=None):
    """(parser, args, cfg): the flags on top of the preset, or on top of
    the ``config.json`` beside ``-m``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_train_args(p)
    add_fusion_args(p)
    add_device_arg(p)
    p.add_argument("--fusion", default="mfm",
                   help="mfm (ThreeTRXShiftLoopTime, bug-faithful) | tsf (score "
                        "fusion) | dga/dga2 (AdaIN) | two_road (ThreeFusionTwoRoad) "
                        "| two_road_videoaxis | a composer preset name "
                        "(TwoTRXShuffleTime, TwoCross, ThreeCross, "
                        "ThreeFusion3, FourShiftFusion, ..., or any *_faithful "
                        "variant) | otam:<preset> for an OTAM head")
    p.add_argument("--score_weights", "-a", nargs="+", type=float,
                   default=None,
                   help="TSF per-modality logit weights (reference --a/--b/--c)")
    p.add_argument("--branch_ckpt", action="append", default=None,
                   metavar="MODALITY=CKPT",
                   help="graft a separately trained expert's episodic head "
                        "into a TSF branch (reference score_fusion_run.py "
                        "--rgb/skeleton/flow_test_model_path): a run.py .pt "
                        "or a run directory of the port; repeatable")
    p.add_argument("--test_only", action="store_true",
                   help="evaluate the teacher given by -m and exit")
    p.add_argument("--test_model_path", "-m", default=None,
                   help="a reference .pt of the --fusion kind's class "
                        "(strict) or a checkpoint directory of the port")
    args = p.parse_args(argv)
    cfg = build_config(args, base=load_saved_config(args.test_model_path))
    return p, args, apply_fusion_args(cfg, args)


def main(argv=None):
    p, args, cfg = parse(argv)
    # usage errors fire before any side effect
    if cfg.data.dataset != "synthetic" and not args.feature_root:
        p.error("teacher training reads per-modality feature trees: pass "
                "--feature_root (or --dataset synthetic for a smoke run)")
    bad = [s for s in args.branch_ckpt or () if "=" not in s]
    if bad:
        p.error(f"--branch_ckpt expects MODALITY=CKPT_DIR, got {bad}")
    dp, device = setup_data_parallel(cfg, args.device)
    writer = dp is None or dp.rank == 0
    set_fp32_math()
    if cfg.train.checkpoint_dir and writer:
        verify_checkpoint_dir(cfg.train.checkpoint_dir,
                              cfg.train.resume_from_checkpoint)
    path = args.test_model_path
    state = create_mfm_train_state(cfg, device, args.fusion,
                                   score_weights=args.score_weights)
    if args.branch_ckpt:
        pairs = dict(s.split("=", 1) for s in args.branch_ckpt)
        load_tsf_branches(state.model, pairs, temp_set=cfg.model.temp_set)
    if path and not os.path.isdir(path):
        # any reference --model <Class> artifact for the matching kind
        state.model.load_state_dict(
            load_reference_fusion_state_dict(path, cfg, args.fusion),
            strict=True)
    log_dir = None if args.debug or args.test_only or not writer else (
        cfg.train.checkpoint_dir or "log")
    logger = MetricsLogger(log_dir=log_dir, run_name=args.fusion,
                           print_freq=cfg.train.print_freq,
                           use_wandb=args.wandb and writer, quiet=not writer)
    logger.info(f"config:\n{cfg.to_json()}")
    if writer:
        save_run_config(cfg)
    if dp is not None:
        dp.barrier()    # the run directory exists before any rank reads it
    sampler = build_mm_sampler(cfg, args.feature_root)
    if args.branch_ckpt:
        logger.info(f"grafted TSF branches from {sorted(pairs)}")
    if path and os.path.isdir(path):
        CheckpointManager(path).restore(state, cfg.train.seed)
        logger.info(f"restored {path} @{state.episodes_seen} episodes")
    elif path:
        logger.info(f"loaded {args.fusion} teacher {path}")

    eval_step = make_mfm_eval_step(cfg)
    if args.test_only:
        shard_train_state(state, dp.axis if dp is not None else None)
        specs = load_fixed_specs(cfg, sampler)
        s = run_eval(cfg, state.model.eval(), sampler,
                     n_tasks=len(specs) if specs else cfg.train.num_test_tasks,
                     eval_step=eval_step, seed=cfg.train.seed, device=device,
                     specs=specs, dp=dp)
        logger.info(f"{cfg.data.dataset}: {s['accuracy']:.2f} ± "
                    f"{s['confidence']:.2f} over {s['n_tasks']} tasks")
        logger.close()
        return s

    history = train_loop(cfg, state, sampler, make_mfm_train_step(cfg, dp),
                         eval_step, logger, device=device, dp=dp)
    if history:
        logger.info("eval history: " + json.dumps(history))
    logger.close()
    return state, history


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()

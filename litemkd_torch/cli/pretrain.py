"""Supervised per-modality pretraining (port of ``litemkd_tpu/cli/pretrain.py``;
the reference's ``pretrain/pretrain.py``):

    python -m litemkd_torch.cli.pretrain --rgb_path FRAMES \\
        --traintestlist SPLITS -c /path/ckpt --epochs 50 [--arch resnet50]

Epochs of mean cross-entropy over every training video of the split, in
batches of ``--batch_size`` clips (the aux frame rule: a plain linspace of
frames, training crops and flips), with the reference's two SGD groups
(trunk ``--lr_1``, head ``--lr_2``, momentum 0.9, StepLR 10/0.1 stepped at
epoch start). After each epoch the test split is evaluated and a checkpoint
is written only when its accuracy improves (every epoch when the test split
is empty). Checkpoints are ``-c/checkpoint_<samples>.pt`` whose
``model_state_dict`` is the reference's ``Action_Recognition_Resnet50``
layout (``convnet.N.*``, ``fc.*``): ``litemkd_torch.cli.extract
--mode_extract expert -m`` and the JAX package's ``load_pretrain_init`` read
it. ``--init_checkpoint`` warm-starts the trunk; ``-r`` resumes from the
newest checkpoint. Runs on cuda unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import VideoStore
from ..data.prefetch import DeferredHostSync, Prefetcher
from ..ops.dtypes import set_fp32_math
from ..tools.weights import load_pretrain_init
from ..train import CheckpointManager, create_pretrain_state, make_pretrain_step
from ..train.loop import move_to_device
from ..utils.logging import MetricsLogger
from .common import (add_common_args, add_device_arg, add_pretrain_args,
                     add_train_args, build_config, resolve_device)


def parse(argv=None):
    """(parser, args, cfg)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_train_args(p)
    add_pretrain_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    return p, args, build_config(args)


def main(argv=None):
    p, args, cfg = parse(argv)
    if not cfg.data.rgb_path:
        p.error("pretraining reads a frame tree: pass --rgb_path "
                "(the synthetic dataset has none)")
    device = resolve_device(args.device)
    set_fp32_math()
    vs = VideoStore(cfg.data.rgb_path, cfg.data.traintestlist, cfg.data.split,
                    cfg.episode.seq_len, cfg.episode.img_size)
    index = vs.split(True)
    records = [(r, r.class_id) for c in index.classes()
               for r in index.videos_for_class(c)]
    n_classes = len(index.classes())
    logger = MetricsLogger(log_dir=None if args.debug else cfg.train.checkpoint_dir,
                           run_name="pretrain", print_freq=cfg.train.print_freq,
                           use_wandb=args.wandb)
    logger.info(f"{len(records)} train videos over {n_classes} classes")
    if args.learning_rate is not None:
        logger.info("warning: --learning_rate is unused by pretrain — the "
                    "reference trains dual SGD groups (pretrain.py:31-38); "
                    "set --lr_1 (trunk) / --lr_2 (head) instead")

    rng = np.random.default_rng(cfg.train.seed)
    # the JAX package loads this clip for its model init; drawing it here
    # too keeps both packages' batches equal
    vs.load(records[0][0], True, rng, frame_rule="aux")
    init_sd = None
    if args.init_checkpoint:
        init_sd = load_pretrain_init(args.init_checkpoint, args.arch)
        logger.info(f"warm-started {args.arch} trunk from {args.init_checkpoint}")
    bs = args.batch_size
    # drop-last batch count, the StepLR epoch length (len(range(0, n-bs+1, bs)))
    steps_per_epoch = max((len(records) - bs) // bs + 1, 1)
    state = create_pretrain_state(cfg, device, n_classes, (args.lr_1, args.lr_2),
                                  steps_per_epoch, arch=args.arch,
                                  init_state_dict=init_sd)
    step = make_pretrain_step(cfg)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir) \
        if cfg.train.checkpoint_dir else None
    if ckpt and cfg.train.resume_from_checkpoint:
        ckpt.restore(state, cfg.train.seed)     # pretrain.py:40-41 --resume
        logger.info(f"resumed from step {state.step}")

    # the test split drives the reference's keep-the-best selection
    # (pretrain.py:142-170: epoch-end eval, save only on improvement)
    test_index = vs.split(False)
    test_records = [(r, r.class_id) for c in test_index.classes()
                    for r in test_index.videos_for_class(c)]
    best_acc = -1.0
    if not test_records:
        # the reference crashes here (its eval loop leaves `acc` unbound);
        # saving every epoch instead keeps a resume from rewinding
        logger.info("warning: test split is empty — keep-the-best selection "
                    "is inactive, saving every epoch instead")

    def transfer(batch):
        return tuple(move_to_device(x, device) for x in batch)

    for epoch in range(args.epochs):
        order = rng.permutation(len(records))
        starts = list(range(0, len(order) - bs + 1, bs))

        def produce(i):
            # one producer thread keeps the rng draw order deterministic
            chunk = [records[j] for j in order[starts[i]:starts[i] + bs]]
            clips = np.stack([vs.load(r, True, rng, frame_rule="aux")
                              for r, _ in chunk])
            return clips, np.asarray([c for _, c in chunk], np.int32)

        sums = [0.0, 0.0, 0]

        def absorb(m):
            sums[0] += float(m["loss"])
            sums[1] += float(m["accuracy"])
            sums[2] += 1

        deferred = DeferredHostSync(absorb)
        for clips, labels in Prefetcher(produce, len(starts), transfer=transfer):
            deferred.push(step(state, clips, labels))
        deferred.flush()
        n_b = max(sums[2], 1)

        # epoch-end eval on the test split; exact accuracy (the reference
        # divides by 8·n_batches even when the last batch is short,
        # pretrain.py:162). The ragged tail is padded to the batch shape, as
        # in the JAX package; padded rows are sliced off the predictions.
        state.model.eval()
        right = total = 0
        with torch.inference_mode():
            for s in range(0, len(test_records), bs):
                chunk = test_records[s:s + bs]
                loaded = [vs.load(r, False, rng, frame_rule="aux") for r, _ in chunk]
                loaded += [loaded[-1]] * (bs - len(chunk))
                labels = np.asarray([c for _, c in chunk], np.int32)
                logits = state.model(move_to_device(np.stack(loaded), device))
                pred = logits.argmax(-1).cpu().numpy()
                right += int((pred[:len(chunk)] == labels).sum())
                total += len(chunk)
        state.model.train()
        test_acc = right / max(total, 1)
        logger.log(epoch, {"epoch_loss": sums[0] / n_b,
                           "epoch_accuracy": sums[1] / n_b,
                           "test_accuracy": test_acc}, force_print=True)
        if test_acc > best_acc or not test_records:
            best_acc = test_acc
            if ckpt:
                ckpt.save(state)
                logger.info(f"epoch {epoch + 1} saved (test acc {test_acc:.4f})")
    logger.close()
    return state


if __name__ == "__main__":
    main()

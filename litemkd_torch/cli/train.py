"""Student distillation training (port of ``litemkd_tpu/cli/train.py``; the
reference's ``train_wandb.sh``):

    python -m litemkd_torch.cli.train --preset student_fc2sup_dist \\
        --pallas_bn --dataset hmdb --rgb_path FRAMES --traintestlist SPLITS \\
        --teacher_path FUSED -c /path/ckpt
    python -m litemkd_torch.cli.train --preset tiny --device cpu -c /tmp/ck

``--rgb_path`` is a JPEG frame tree ``<class>/<video>/<frame>.jpg``, decoded
on the host by ``--num_workers`` threads; ``--teacher_path`` is the fused
feature tree that ``litemkd_torch.cli.extract --mode_extract mfm`` writes,
paired with each video by class name and video id; ``--dataset synthetic``
draws clips and features in memory instead. Runs on cuda unless
``--device`` says otherwise, with TF32 off in matrix products and
convolutions (the bf16 trunk is unaffected). ``--teacher_checkpoint`` loads a
reference-layout teacher ``.pt`` and ``--init_checkpoint`` a
reference-layout student ``.pt`` (strict); otherwise both get random
weights from the seed. Checkpoints and ``config.json`` go to ``-c``; the
eval CLI reads them with ``-m <dir>/checkpoint_<episodes>.pt``.
"""
from __future__ import annotations

import argparse
import json

from ..models import BatchedTeacher
from ..tools.weights import (load_reference_state_dict,
                             teacher_state_dict_from_reference)
from ..train import run_training, verify_checkpoint_dir
from ..utils.logging import MetricsLogger
from .common import (add_common_args, add_device_arg, add_train_args,
                     build_config, build_sampler, resolve_device,
                     save_run_config, set_fp32_math)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_train_args(p)
    add_device_arg(p)
    p.add_argument("--init_checkpoint", default=None,
                   help="warm-start the student from a reference-layout .pt")
    args = p.parse_args(argv)
    return args, build_config(args)


def main(argv=None):
    args, cfg = parse(argv)
    device = resolve_device(args.device)
    set_fp32_math()
    if cfg.train.checkpoint_dir:
        verify_checkpoint_dir(cfg.train.checkpoint_dir,
                              cfg.train.resume_from_checkpoint)
    logger = MetricsLogger(
        log_dir=None if args.debug else (cfg.train.checkpoint_dir or "log"),
        run_name=cfg.mode, print_freq=cfg.train.print_freq)
    logger.info(f"config:\n{cfg.to_json()}")
    save_run_config(cfg)
    sampler = build_sampler(cfg, need_teacher=True)

    teacher_sd = student_sd = None
    if args.teacher_checkpoint:
        teacher_sd = teacher_state_dict_from_reference(
            load_reference_state_dict(args.teacher_checkpoint),
            BatchedTeacher(cfg))
        logger.info(f"loaded teacher head from {args.teacher_checkpoint}")
    if args.init_checkpoint:
        student_sd = load_reference_state_dict(args.init_checkpoint)
        logger.info(f"warm-started student from {args.init_checkpoint}")

    state, history = run_training(cfg, sampler, logger, device=device,
                                  teacher_state_dict=teacher_sd,
                                  student_state_dict=student_sd)
    if history:
        logger.info("eval history: " + json.dumps(history))
    logger.close()
    return state, history


if __name__ == "__main__":
    main()

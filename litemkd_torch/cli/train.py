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
reference-layout teacher ``.pt``; ``--init_checkpoint`` warm-starts the
student from a reference student ``.pt``, a run.py, TRM, CNN_STRM, S3D or
teacher-half CTX expert artifact, or a torchvision resnet or
``mobilenet_v3`` zoo file (the trunk alone; the rest keeps its seeded
init); otherwise both get random weights from the seed. Checkpoints and
``config.json`` go to ``-c``; the eval CLI reads them with
``-m <dir>/checkpoint_<episodes>.pt``. The per-modality TRX expert
(reference ``run.py``) trains through the same CLI:

    python -m litemkd_torch.cli.train --preset expert_trx --remat \\
        --rgb_path FRAMES --traintestlist SPLITS --teacher_path FUSED -c DIR

(as in the JAX package the CLI reads a teacher tree and runs the frozen
teacher head, whose logits ``TRXLoss`` ignores).

Data- and tensor-parallel over several processes (one per card; gloo on
the CPU; ``litemkd_torch.parallel``): ``--mesh_data D --mesh_model M``
over D·M ranks, each replica of M ranks drawing its share of every batch
and cutting the wide projections (the TCT's k/v maps, the backbone's
fc1/fc2) over its ranks. Rank 0 writes the checkpoints (in the one-process
layout), ``config.json`` and the logs:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m litemkd_torch.cli.train --preset student_fc2sup_dist \
        --mesh_data 2 --mesh_model 2 ... -c DIR
"""
from __future__ import annotations

import argparse
import json

from ..models import BatchedTeacher
from ..ops.dtypes import set_fp32_math
from ..parallel import shutdown
from ..tools.weights import (load_reference_checkpoint, load_student_checkpoint,
                             teacher_state_dict_from_reference)
from ..train import run_training, verify_checkpoint_dir
from ..utils.logging import MetricsLogger
from .common import (add_common_args, add_device_arg, add_train_args,
                     build_config, build_sampler, save_run_config,
                     setup_data_parallel)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_train_args(p)
    add_device_arg(p)
    p.add_argument("--init_checkpoint", default=None,
                   help="warm-start the student from a reference student "
                        ".pt, an expert .pt (run.py, TRM, CNN_STRM, S3D, "
                        "teacher CTX) or a torchvision resnet/mobilenet_v3 "
                        "zoo file (trunk only)")
    args = p.parse_args(argv)
    return args, build_config(args)


def main(argv=None):
    args, cfg = parse(argv)
    dp, device = setup_data_parallel(cfg, args.device)
    writer = dp is None or dp.rank == 0
    set_fp32_math()
    if cfg.train.checkpoint_dir and writer:
        verify_checkpoint_dir(cfg.train.checkpoint_dir,
                              cfg.train.resume_from_checkpoint)
    logger = MetricsLogger(
        log_dir=None if args.debug or not writer
        else (cfg.train.checkpoint_dir or "log"),
        run_name=cfg.mode, print_freq=cfg.train.print_freq,
        use_wandb=args.wandb and writer, quiet=not writer)
    logger.info(f"config:\n{cfg.to_json()}")
    if dp is not None:
        logger.info(f"mesh {dp.data}x{dp.model} over {dp.world} ranks "
                    f"({cfg.train.tasks_per_batch // dp.data} episodes a "
                    "replica)")
    if writer:
        save_run_config(cfg)
    if dp is not None:
        dp.barrier()    # the run directory exists before any rank reads it
    sampler = build_sampler(cfg, need_teacher=True)

    teacher_sd = student_sd = None
    if args.teacher_checkpoint:
        teacher_sd = teacher_state_dict_from_reference(
            load_reference_checkpoint(args.teacher_checkpoint)[0],
            BatchedTeacher(cfg))
        logger.info(f"loaded teacher head from {args.teacher_checkpoint}")
    if args.init_checkpoint:
        student_sd = load_student_checkpoint(args.init_checkpoint, cfg)
        logger.info(f"warm-started student from {args.init_checkpoint}")

    state, history = run_training(cfg, sampler, logger, device=device,
                                  teacher_state_dict=teacher_sd,
                                  student_state_dict=student_sd, dp=dp)
    if history:
        logger.info("eval history: " + json.dumps(history))
    logger.close()
    return state, history


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()

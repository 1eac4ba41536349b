"""Episodic evaluation of a student or of the teacher (port of
``litemkd_tpu/cli/test.py:21-120``; the reference's ``test.sh``).

    python -m litemkd_torch.cli.test --dataset hmdb --rgb_path FRAMES \\
        --traintestlist SPLITS -m DIR/checkpoint_N.pt \\
        [--fixed_episode_file fixed.json] [--per_task_log tasks.jsonl]
    python -m litemkd_torch.cli.test --test_model teacher --dataset hmdb \\
        --rgb_path FRAMES --teacher_path FUSED --traintestlist SPLITS \\
        -m TEACHER.pt
    python -m litemkd_torch.cli.test --preset tiny --device cpu

Student mode: ``-m`` takes a reference-layout student ``.pt`` (the port's
checkpoint or the reference's, DataParallel ``module.`` keys included;
strict). Teacher mode scores the frozen teacher head (its ``kl`` branch)
on the fused features of ``--teacher_path``, with the clips sampled too,
as the JAX package's sampler does: ``-m`` takes a teacher ``.pt`` whose
TCT sits under any prefix (``bracnch.transformers.0`` in the reference's
teacher files and in an MFM checkpoint of the port); a checkpoint
directory (the JAX package's Orbax format) is not read. Without ``-m`` the
weights are random from ``cfg.train.seed`` (seed + 1 for the teacher, as
in training). ``--fixed_episode_file`` replays the episodes of a file that
``litemkd_torch.cli.gen_fixed_split`` wrote, or of the reference's
``fixed_test`` JSON/YAML. ``--per_task_log`` writes one JSON line per task
(``tools/confusion.py`` reads them). Prints mean accuracy ×100 with the
196·std/√n confidence interval. Runs on cuda unless ``--device`` says
otherwise, with TF32 off in matrix products and convolutions (the bf16
trunk is unaffected). Under ``torchrun`` the eval is sharded over the
replicas of ``--mesh_data`` (each evaluates its slice of every chunk; the
results are gathered in task order, and ``n_tasks`` is rounded to whole
chunks) and the model over the ranks of ``--mesh_model``, with the summary
and ``--per_task_log`` of one process:

    python -m torch.distributed.run --nproc_per_node 4 \
        -m litemkd_torch.cli.test -m DIR/checkpoint_N.pt --mesh_data 2 \
        --mesh_model 2
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple

import torch

from ..config import Config
from ..models import BatchedStudent, BatchedTeacher, init_student_
from ..ops.dtypes import set_fp32_math
from ..parallel import shutdown
from ..tools.weights import (load_reference_checkpoint,
                             teacher_state_dict_from_reference)
from ..parallel import shard_model
from ..train import make_eval_step, make_teacher_eval_step, run_eval
from .common import (add_common_args, add_device_arg, add_test_args,
                     build_config, build_sampler, load_fixed_specs,
                     load_saved_config, resolve_device, setup_data_parallel)


def load_student(cfg: Config, path: Optional[str] = None,
                 device=None) -> BatchedStudent:
    """An eval-mode ``BatchedStudent`` on ``device`` (default cuda, which
    must then be available): weights from a reference-layout ``.pt`` file
    (strict, with DataParallel ``module.`` segments dropped), or random
    from ``cfg.train.seed``."""
    model = BatchedStudent(cfg)
    if path:
        model.load_state_dict(load_reference_checkpoint(path)[0], strict=True)
    else:
        init_student_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(resolve_device(device)).eval()


def load_teacher(cfg: Config, path: Optional[str] = None,
                 device=None) -> BatchedTeacher:
    """An eval-mode ``BatchedTeacher`` on ``device``: its TCT from a
    teacher ``.pt`` (``teacher_state_dict_from_reference``), or random from
    ``cfg.train.seed + 1``, the seed of the teacher in training."""
    teacher = BatchedTeacher(cfg)
    if path and os.path.isdir(path):
        raise ValueError(f"{path} is a directory: the port reads teacher .pt "
                         "files, not the JAX package's Orbax checkpoints")
    if path:
        teacher.load_state_dict(teacher_state_dict_from_reference(
            load_reference_checkpoint(path)[0], teacher), strict=True)
    else:
        init_student_(teacher, torch.Generator().manual_seed(cfg.train.seed + 1))
    return teacher.to(resolve_device(device)).eval()


def parse(argv=None) -> Tuple[argparse.Namespace, Config]:
    """Parse the eval flags into (args, cfg)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_test_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    return args, build_config(args, base=load_saved_config(args.test_model_path))


def main(argv=None):
    args, cfg = parse(argv)
    dp, device = setup_data_parallel(cfg, args.device)
    writer = dp is None or dp.rank == 0
    set_fp32_math()
    teacher_mode = args.test_model == "teacher"
    sampler = build_sampler(cfg, need_teacher=teacher_mode)
    with_preds = args.per_task_log is not None
    if teacher_mode:
        model = load_teacher(cfg, args.test_model_path, device)
        eval_step = make_teacher_eval_step(cfg, with_preds=with_preds)
    else:
        model = load_student(cfg, args.test_model_path, device)
        eval_step = make_eval_step(cfg, with_preds=with_preds)
    if dp is not None and dp.axis is not None:
        shard_model(model, dp.axis)
    if args.test_model_path and writer:
        print(f"loaded torch checkpoint {args.test_model_path}")
    specs = load_fixed_specs(cfg, sampler)
    task_log = log_file = None
    if with_preds:
        # every rank sees every task (run_eval gathers them); rank 0 writes
        log_file = open(args.per_task_log, "w") if writer else None

        def task_log(record):
            if log_file is not None:
                log_file.write(json.dumps(record) + "\n")

    try:
        summary = run_eval(
            cfg, model, sampler,
            n_tasks=len(specs) if specs else cfg.train.num_test_tasks,
            seed=cfg.train.seed, eval_step=eval_step, device=device,
            specs=specs, task_log=task_log, dp=dp)
    finally:
        if log_file is not None:
            log_file.close()
    if writer:
        if with_preds:
            print(f"per-task records written to {args.per_task_log}")
        print(f"{cfg.data.dataset}: {summary['accuracy']:.2f} ± "
              f"{summary['confidence']:.2f} over {summary['n_tasks']} tasks")
    return summary


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()

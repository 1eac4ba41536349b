"""Episodic evaluation of a student (port of the student mode of
``litemkd_tpu/cli/test.py:21-120``; the reference's ``test.sh``).

    python -m litemkd_torch.cli.test --preset student_fc2sup_dist \\
        --dataset synthetic -m student.pt          # reference-layout weights
    python -m litemkd_torch.cli.test --preset tiny --device cpu

Without ``-m`` the student gets random weights from a ``torch.Generator``
seeded with ``cfg.train.seed``. Prints mean accuracy ×100 with the
196·std/√n confidence interval over ``num_test_tasks`` episodes. Runs on
cuda unless ``--device`` says otherwise, with TF32 off in matrix products
and convolutions (the bf16 trunk is unaffected).
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from ..config import Config
from ..models import BatchedStudent, init_student_
from ..train import run_eval
from .common import (add_common_args, add_device_arg, add_test_args,
                     build_config, build_sampler, load_saved_config,
                     resolve_device, set_fp32_math)


def load_student(cfg: Config, path: Optional[str] = None,
                 device=None) -> BatchedStudent:
    """An eval-mode ``BatchedStudent`` on ``device`` (default cuda, which
    must then be available): weights from a reference-layout ``.pt`` file
    (strict), or random from ``cfg.train.seed``."""
    model = BatchedStudent(cfg)
    if path:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt.get("model_state_dict", ckpt), strict=True)
    else:
        init_student_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(resolve_device(device)).eval()


def parse(argv=None) -> Tuple[argparse.Namespace, Config]:
    """Parse the eval flags into (args, cfg); rejects a saved config that
    asks for fixed-episode replay, which is not ported."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_test_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = build_config(args, base=load_saved_config(args.test_model_path))
    if cfg.data.fixed_episode_file:
        raise NotImplementedError("fixed-episode replay is not ported yet")
    return args, cfg


def main(argv=None):
    args, cfg = parse(argv)
    device = resolve_device(args.device)
    set_fp32_math()
    sampler = build_sampler(cfg, need_teacher=False)
    model = load_student(cfg, args.test_model_path, device)
    if args.test_model_path:
        print(f"loaded torch checkpoint {args.test_model_path}")
    summary = run_eval(cfg, model, sampler, n_tasks=cfg.train.num_test_tasks,
                       seed=cfg.train.seed, device=device)
    print(f"{cfg.data.dataset}: {summary['accuracy']:.2f} ± "
          f"{summary['confidence']:.2f} over {summary['n_tasks']} tasks")
    return summary


if __name__ == "__main__":
    main()

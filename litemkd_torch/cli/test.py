"""Episodic evaluation of a student (port of the student mode of
``litemkd_tpu/cli/test.py:21-120``; the reference's ``test.sh``).

    python -m litemkd_torch.cli.test --dataset hmdb --rgb_path FRAMES \\
        --traintestlist SPLITS -m DIR/checkpoint_N.pt \\
        [--fixed_episode_file fixed.json]
    python -m litemkd_torch.cli.test --preset tiny --device cpu

``-m`` takes a reference-layout student ``.pt`` (the port's checkpoint or
the reference's, DataParallel ``module.`` keys included; strict); without
it the student gets random weights from a ``torch.Generator`` seeded with
``cfg.train.seed``. ``--fixed_episode_file`` replays the episodes of a
file that ``litemkd_torch.cli.gen_fixed_split`` wrote, or of the
reference's ``fixed_test`` JSON/YAML. Prints mean accuracy ×100 with the
196·std/√n confidence interval. Runs on cuda unless ``--device`` says
otherwise, with TF32 off in matrix products and convolutions (the bf16
trunk is unaffected).
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from ..config import Config
from ..models import BatchedStudent, init_student_
from ..tools.weights import load_reference_state_dict
from ..train import run_eval
from .common import (add_common_args, add_device_arg, add_test_args,
                     build_config, build_sampler, load_fixed_specs,
                     load_saved_config, resolve_device, set_fp32_math)


def load_student(cfg: Config, path: Optional[str] = None,
                 device=None) -> BatchedStudent:
    """An eval-mode ``BatchedStudent`` on ``device`` (default cuda, which
    must then be available): weights from a reference-layout ``.pt`` file
    (strict, with DataParallel ``module.`` segments dropped), or random
    from ``cfg.train.seed``."""
    model = BatchedStudent(cfg)
    if path:
        model.load_state_dict(load_reference_state_dict(path), strict=True)
    else:
        init_student_(model, torch.Generator().manual_seed(cfg.train.seed))
    return model.to(resolve_device(device)).eval()


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
    device = resolve_device(args.device)
    set_fp32_math()
    sampler = build_sampler(cfg, need_teacher=False)
    model = load_student(cfg, args.test_model_path, device)
    if args.test_model_path:
        print(f"loaded torch checkpoint {args.test_model_path}")
    specs = load_fixed_specs(cfg, sampler)
    summary = run_eval(cfg, model, sampler,
                       n_tasks=len(specs) if specs else cfg.train.num_test_tasks,
                       seed=cfg.train.seed, device=device, specs=specs)
    print(f"{cfg.data.dataset}: {summary['accuracy']:.2f} ± "
          f"{summary['confidence']:.2f} over {summary['n_tasks']} tasks")
    return summary


if __name__ == "__main__":
    main()

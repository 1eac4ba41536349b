"""Worker of tests/test_torch_port_chunk_spans.py (not a pytest module): one
rank of a process group, started by ``torch.distributed.run`` (gloo on
``--device cpu``, NCCL with one card a rank on ``--device cuda``), that
trains one step for each case of ``--init``: micro-batch chunks that span
some replicas but not all.

Each case is a config whose mesh lays out the world. Every rank runs one
``run_training`` step of it with the weights of ``--init`` and keeps its
metrics, the student's state dict and gradients in the one-process layout,
its kernel launches and its pieces of the chunks. Rank 0 saves what it saw
to ``--out`` (torch.save, on the CPU); every rank saves the checksums of
its student after each case to ``--out.<rank>``. With ``--cli`` the ranks
then run ``litemkd_torch.cli.train`` with those flags and ``-c --ckdir``.

    python -m torch.distributed.run --nproc_per_node 4 \\
        tests/torch_chunk_span_worker.py --init INIT.pt --out OUT.pt \\
        [--ckdir DIR --cli "--preset tiny ..."] [--device cuda]
"""
import argparse
import os
import shlex
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_parallel_worker import Capture, _cpu, kernel_launches  # noqa: E402
from torch_tensor_parallel_worker import full_grads  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ckdir", default=None)
    p.add_argument("--cli", default=None)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args()
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from litemkd_torch.cli.common import setup_data_parallel
    from litemkd_torch.cli.train import main as train_cli
    from litemkd_torch.config import Config
    from litemkd_torch.data import SyntheticEpisodeSource
    from litemkd_torch.parallel import full_state_dict
    from litemkd_torch.parallel.data_parallel import chunk_plan
    from litemkd_torch.train import run_training

    init = torch.load(args.init, weights_only=False)
    out = {"cases": {}}
    checks = {}
    dp = None
    for name, cfg_json in init["cases"].items():
        cfg = Config.from_dict(cfg_json)
        dp, device = setup_data_parallel(cfg, args.device)
        sampler = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                         noise=cfg.data.synthetic_noise)
        log = Capture()
        before = kernel_launches()
        t0 = time.perf_counter()
        state, _ = run_training(cfg, sampler, log, device=device,
                                student_state_dict=init["student"],
                                teacher_state_dict=init["teacher"], dp=dp)
        sd = _cpu(full_state_dict(state.model))
        out["cases"][name] = {
            "metrics": log.records,
            "state_dict": sd,
            "grads": _cpu(full_grads(state.model)),
            "episodes_seen": state.episodes_seen,
            "launches": [a - b for a, b in zip(kernel_launches(), before)],
            "pieces": [tuple(x[:4]) + (tuple(x.members),) for x in chunk_plan(
                cfg.train.micro_batch, cfg.train.tasks_per_batch, dp.data,
                dp.data_index)],
            "seconds": time.perf_counter() - t0,
        }
        checks[name] = sum(float(v.double().sum()) for v in sd.values())
    torch.save(checks, f"{args.out}.{dp.rank}")

    if args.cli:
        train_cli(shlex.split(args.cli) + ["-c", args.ckdir])

    out["world"], out["rank"] = dp.world, dp.rank
    if dp.rank == 0:
        torch.save(out, args.out)
    dp.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

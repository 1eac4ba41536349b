"""Worker of tests/test_torch_port_parallel.py and of the multi-card test in
tests/test_torch_port_cuda.py (not a pytest module): one rank of a process
group, started by ``torch.distributed.run`` (gloo on ``--device cpu``, NCCL
with one card a rank on ``--device cuda``).

Every rank runs, in order, with the weights and configs of ``--init``:
- one data-parallel ``run_training`` step per scenario (its metrics, and
  the student's state dict and gradients after it);
- a sharded ``run_eval`` of the first scenario's trained student, with its
  per-task records;
- one data-parallel MFM step (``train_loop`` with ``make_mfm_train_step``);
- ``litemkd_torch.cli.train`` over the group (``--mesh_data`` the world
  size, 4 episodes in all), into ``--ckdir``;
- ``setup_data_parallel`` with a ``model`` axis of 3, which does not divide
  the world (it must raise JAX's ``make_mesh`` error).
Rank 0 saves what it saw to ``--out`` (torch.save, on the CPU), with the
launches of each kernel during each scenario's step; every rank saves the
checksum of its own student after the first scenario to ``--out.<rank>``.

    python -m torch.distributed.run --nproc_per_node 2 \\
        tests/torch_parallel_worker.py --init INIT.pt --out OUT.pt --ckdir DIR \\
        [--device cuda]
"""
import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def concat_batches(shards):
    """The global batch of the ranks' shards, in rank order (numpy)."""
    import numpy as np

    def cat(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        return np.concatenate(xs, axis=0)

    return type(shards[0])(*(cat(*f) for f in zip(*shards)))


def kernel_launches():
    """(TCT, BN sums, BN backward sums) launches so far in this process."""
    from litemkd_torch.ops import batch_norm as bn
    from litemkd_torch.ops import tct_attention as ta
    return (ta.tct_attention.launches, bn.bn_sums.launches,
            bn.bn_bwd_sums.launches)


def _cpu(sd):
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


class MetaSource:
    """A synthetic source that also returns episode metadata (its classes
    in order, the query labels as the real ones), for ``run_eval``'s
    ``task_log``."""

    def __init__(self, src):
        self.src = src

    def sample_batch(self, rng, n, train=False, return_meta=False, **kw):
        from types import SimpleNamespace
        import numpy as np
        batch = self.src.sample_batch(rng, n, train=train, **kw)
        if not return_meta:
            return batch
        way = self.src.cfg.episode.way
        return batch, SimpleNamespace(
            classes=np.tile(np.arange(way) * 10, (n, 1)),
            real_query_labels=batch.query_labels * 10)


class Capture:
    """A MetricsLogger stand-in that keeps the step metrics."""

    def __init__(self):
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append({k: float(v) for k, v in scalars.items()})

    def info(self, msg):
        pass


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--init", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ckdir", required=True)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = p.parse_args()
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from litemkd_torch.cli.common import setup_data_parallel
    from litemkd_torch.cli.train import main as train_cli
    from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
    from litemkd_torch.config import Config, MeshConfig
    from litemkd_torch.data import SyntheticEpisodeSource
    from litemkd_torch.train import (create_mfm_train_state, make_mfm_eval_step,
                                     make_mfm_train_step, run_eval, run_training,
                                     train_loop)

    init = torch.load(args.init, weights_only=False)
    out = {"scenarios": {}}
    dp = None
    for name, cfg_json in init["scenarios"].items():
        cfg = Config.from_dict(cfg_json)
        dp, device = setup_data_parallel(cfg, args.device)
        sampler = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                         noise=cfg.data.synthetic_noise)
        log = Capture()
        before = kernel_launches()
        state, _ = run_training(cfg, sampler, log, device=device,
                                student_state_dict=init["student"],
                                teacher_state_dict=init["teacher"], dp=dp)
        out["scenarios"][name] = {
            "metrics": log.records,
            "state_dict": _cpu(state.model.state_dict()),
            "grads": _cpu({n: p.grad for n, p in state.model.named_parameters()
                           if p.grad is not None}),
            "episodes_seen": state.episodes_seen,
            "launches": [a - b for a, b in zip(kernel_launches(), before)],
        }
        if name == "span":
            records = []
            out["eval"] = run_eval(cfg, state.model.eval(), MetaSource(sampler),
                                   n_tasks=20,
                                   batch_size=8, seed=0, dp=dp,
                                   task_log=records.append)
            out["eval_records"] = records
            out["eval_model"] = out["scenarios"][name]["state_dict"]
            torch.save(sum(float(v.double().sum())
                           for v in state.model.state_dict().values()),
                       f"{args.out}.{dp.rank}")

    mcfg = Config.from_dict(init["mfm"])
    state = create_mfm_train_state(mcfg, device)
    log = Capture()
    train_loop(mcfg, state, SyntheticMultiModalSource(mcfg, seed=mcfg.train.seed),
               make_mfm_train_step(mcfg, dp), make_mfm_eval_step(mcfg), log,
               device=device, dp=dp)
    out["mfm"] = {"metrics": log.records,
                  "state_dict": _cpu(state.model.state_dict()),
                  "episodes_seen": state.episodes_seen}

    # tiny's 2 episodes a step, or one a rank over more ranks
    train_cli(["--preset", "tiny", "--dataset", "synthetic", "--device",
               args.device, "--mesh_data", str(dp.world), "--tasks_per_batch",
               str(max(2, dp.world)), "-c", args.ckdir])

    bad = dataclasses.replace(mcfg, mesh=MeshConfig(data=-1, model=3))
    try:
        setup_data_parallel(bad, args.device)
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)

    out["world"], out["rank"] = dp.world, dp.rank
    if dp.rank == 0:
        torch.save(out, args.out)
    dp.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

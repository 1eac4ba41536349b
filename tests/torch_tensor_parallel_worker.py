"""Worker of tests/test_torch_port_tensor_parallel.py and of the multi-card
tensor-parallel test in tests/test_torch_port_cuda.py (not a pytest
module): one rank of a process group, started by ``torch.distributed.run``
(gloo on ``--device cpu``, NCCL with one card a rank on ``--device cuda``).

For each (data, model) mesh of ``--init`` (data × model = the world), every
rank runs, in order, with that init's weights and configs:
- the column and row layers against ``nn.Linear``, forward and backward;
- one ``run_training`` step per student scenario (its metrics, kernel
  launches, and the student's state dict and gradients gathered to the
  one-process layout), and where the mesh has one replica the dropout
  scenario;
- a sharded ``run_eval`` of the first scenario's trained student, with its
  per-task records;
- one MFM step (``train_loop`` with ``make_mfm_train_step``);
then, at the mesh ``cli_mesh``, ``litemkd_torch.cli.train`` and
``cli.train_teacher`` into ``--ckdir`` (2 steps, then a resume to 4 more
episodes), ``cli.test`` of the student checkpoint, and
``setup_data_parallel`` with a ``model`` axis of 3, which must raise.
Rank 0 saves what it saw to ``--out`` (torch.save, on the CPU); every rank
saves the checksum of the first scenario's gathered student and of its
replicated parameters to ``--out.<rank>``.

    python -m torch.distributed.run --nproc_per_node 4 \\
        tests/torch_tensor_parallel_worker.py --init INIT.pt --out OUT.pt \\
        --ckdir DIR [--device cuda]
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_parallel_worker import (Capture, MetaSource, _cpu,  # noqa: E402
                                   kernel_launches)


def full_grads(model):
    """Every gradient of ``model`` in the one-process layout (a collective
    over the model group)."""
    from litemkd_torch.parallel.tensor_parallel import (_parts,
                                                        unshard_tensor)
    axis = getattr(model, "tp_axis", None)
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        spec = getattr(p, "tp_spec", None)
        out[n] = p.grad if spec is None else unshard_tensor(
            _parts(p.grad, axis), spec)
    return out


def layers_against_linear(axis, device):
    """A lone column layer and a column → ReLU → row pair against their
    ``nn.Linear``s on the same seeded weights and inputs: outputs, the
    input's gradient and every weight's (gathered)."""
    from litemkd_torch.parallel.tensor_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear,
                                                        full_state_dict)
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device)

    x, gy, gz = t(6, 8), t(6, 8), t(6, 16)
    out = {}
    for parallel in (False, True):
        torch.manual_seed(0)
        net = torch.nn.ModuleDict({"a": torch.nn.Linear(8, 16),
                                   "b": torch.nn.Linear(16, 8),
                                   "c": torch.nn.Linear(8, 16)}).to(device)
        if parallel:
            net["a"] = ColumnParallelLinear(net["a"], axis, gather=False)
            net["b"] = RowParallelLinear(net["b"], axis)
            net["c"] = ColumnParallelLinear(net["c"], axis)
            net.tp_axis = axis
        xi = x.clone().requires_grad_(True)
        y = net["b"](torch.relu(net["a"](xi)))
        z = net["c"](xi)
        ((y * gy).sum() + (z * gz).sum()).backward()
        out["tp" if parallel else "linear"] = {
            "y": y.detach().cpu(), "z": z.detach().cpu(),
            "dx": xi.grad.cpu(), "grads": _cpu(full_grads(net)),
            "state": _cpu(full_state_dict(net))}
    return out


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
    from litemkd_torch.cli.test import main as test_cli
    from litemkd_torch.cli.train import main as train_cli
    from litemkd_torch.cli.train_teacher import (SyntheticMultiModalSource,
                                                 main as teacher_cli)
    from litemkd_torch.config import Config, MeshConfig
    from litemkd_torch.data import SyntheticEpisodeSource
    from litemkd_torch.parallel import (Mesh, full_state_dict, init_distributed,
                                        sharded_parameters)
    from litemkd_torch.train import (create_mfm_train_state, make_mfm_eval_step,
                                     make_mfm_train_step, run_eval, run_training,
                                     train_loop)

    init = torch.load(args.init, weights_only=False)
    base = init_distributed(args.device)
    device = base.device
    out = {"meshes": {}, "world": base.world}
    checks = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for mesh in init["meshes"]:
        dp = base.with_mesh(Mesh(*mesh))
        res = {"layers": layers_against_linear(dp.axis, device),
               "scenarios": {}}
        scenarios = dict(init["scenarios"])
        if dp.data == 1 and "dropout" in init:
            scenarios["dropout"] = init["dropout"]
        for name, cfg_json in scenarios.items():
            cfg = Config.from_dict(cfg_json)
            sampler = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                             noise=cfg.data.synthetic_noise)
            log = Capture()
            before = kernel_launches()
            sync()
            t0 = time.perf_counter()
            state, _ = run_training(cfg, sampler, log, device=device,
                                    student_state_dict=init["student"],
                                    teacher_state_dict=init["teacher"], dp=dp)
            sync()
            seconds = time.perf_counter() - t0
            res["scenarios"][name] = {
                "metrics": log.records,
                "state_dict": _cpu(full_state_dict(state.model)),
                "grads": _cpu(full_grads(state.model)),
                "episodes_seen": state.episodes_seen,
                "launches": [a - b for a, b in zip(kernel_launches(), before)],
                "sharded": sorted(sharded_parameters(state.model)),
                "teacher_sharded": sorted(sharded_parameters(state.teacher)),
                "seconds": seconds,
            }
            if name == "span":
                records = []
                res["eval"] = run_eval(cfg, state.model.eval(),
                                       MetaSource(sampler), n_tasks=20,
                                       batch_size=8, seed=0, dp=dp,
                                       task_log=records.append)
                res["eval_records"] = records
                full = res["scenarios"][name]["state_dict"]
                rep = {n: v for n, v in state.model.named_parameters()
                       if getattr(v, "tp_spec", None) is None}
                checks[tuple(mesh)] = (
                    sum(float(v.double().sum()) for v in full.values()),
                    sum(float(v.detach().double().sum()) for v in rep.values()))

        mcfg = Config.from_dict(init["mfm"])
        state = create_mfm_train_state(mcfg, device, state_dict=init["mfm_state"])
        log = Capture()
        before = kernel_launches()
        train_loop(mcfg, state, SyntheticMultiModalSource(mcfg, seed=mcfg.train.seed),
                   make_mfm_train_step(mcfg, dp), make_mfm_eval_step(mcfg), log,
                   device=device, dp=dp)
        res["mfm"] = {"metrics": log.records,
                      "state_dict": _cpu(full_state_dict(state.model)),
                      "episodes_seen": state.episodes_seen,
                      "launches": [a - b for a, b in
                                   zip(kernel_launches(), before)],
                      "sharded": sorted(sharded_parameters(state.model))}
        out["meshes"][tuple(mesh)] = res

    d, m = init["cli_mesh"]
    flags = ["--device", args.device, "--mesh_data", str(d), "--mesh_model",
             str(m)]
    for name, cli in (("train", train_cli), ("teacher", teacher_cli)):
        ck = os.path.join(args.ckdir, name)
        common = ["--preset", "tiny", "--dataset", "synthetic", "-c", ck,
                  "--tasks_per_batch", str(max(2, d))] + flags
        cli(common)
        cli(common + ["-i", "8", "--resume_from_checkpoint"])
    out["cli_test"] = test_cli(["-m", os.path.join(args.ckdir, "train",
                                                  "checkpoint_4.pt"),
                                "--num_test_tasks", "8"] + flags)

    bad = Config().replace(mesh=MeshConfig(data=-1, model=3))
    try:
        setup_data_parallel(bad, args.device)
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)

    out["rank"] = base.rank
    torch.save(checks, f"{args.out}.{base.rank}")
    if base.rank == 0:
        torch.save(out, args.out)
    base.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

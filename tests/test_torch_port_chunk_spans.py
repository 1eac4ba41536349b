"""Micro-batch chunks that span some replicas but not all: the port's
data-parallel step over gloo process groups on the CPU against the JAX
package's ``data``-sharded step on the virtual CPU mesh and against the
port's one-process step on the replicas' shards concatenated.

Cases (world, (data, model), episodes E, micro_batch):
- world 2, (2, 1), E 6, micro 2: chunk 1 lies across both ranks;
- world 4, (4, 1), E 8, micro 4: each chunk over two ranks, each rank's
  geometry of the flagship's 16 episodes over 8 ranks;
- world 4, (4, 1), E 12, micro 4: uneven pieces (3 + 1, 2 + 2, 1 + 3);
- world 4, (2, 2), E 6, micro 2: the same across the replicas of a mesh
  with a model axis.
Each on both BatchNorm paths (``pallas_bn`` and not; on the CPU both take
the plain sums). The ranks run in ``tests/torch_chunk_span_worker.py``
under ``torch.distributed.run``, once at world 2 and once at world 4, the
latter also running ``cli.train --mesh_data 4 --tasks_per_batch 8
--micro_batch 4``. Tiny preset, fp32, dropout 0, JAX weights carried across
with ``litemkd_torch.tools.weights``, every BatchNorm bias at +3 as in
``tests/test_torch_port_parallel.py``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import litemkd_torch.config as torch_config
from litemkd_torch.parallel.data_parallel import chunk_plan
from litemkd_torch.tools.weights import student_state_dict_from_jax
from litemkd_tpu.train.steps import EpisodeBatch as JaxEpisodeBatch

from test_torch_port_parallel import (_free_port, _jax_cfg, _port_cfg,
                                      _port_weights, jax_weights)  # noqa: F401
from test_torch_port_tensor_parallel import (_assert_step, _jax_student_step,
                                             _one_process_batch,
                                             _one_process_step)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_chunk_span_worker.py"
CLI = ("--preset tiny --dataset synthetic --device cpu --mesh_data 4 "
       "--tasks_per_batch 8 --micro_batch 4")

torch.set_num_threads(2)

# name → (world, (data, model), tasks_per_batch, micro_batch)
CASES = {
    "w2_e6_m2": (2, (2, 1), 6, 2),
    "w4_e8_m4": (4, (4, 1), 8, 4),
    "w4_e12_m4": (4, (4, 1), 12, 4),
    "w4_d2m2_e6_m2": (4, (2, 2), 6, 2),
}
BN_PATHS = {"plain": False, "kernel": True}
RUNS = [(c, b) for c in CASES for b in BN_PATHS]
# with per-block remat the recompute runs each spanning BatchNorm's
# collectives again, in the same order on every rank
REMAT = ("w4_e12_m4", "kernel")


def _case_cfg(name, module, pallas_bn=False, remat=False):
    _, _, tpb, micro = CASES[name]
    cfg = module(tasks_per_batch=tpb, micro_batch=micro, training_iterations=tpb,
                 test_iters=(), print_freq=0)
    return cfg.replace(model=dataclasses.replace(cfg.model, pallas_bn=pallas_bn,
                                                 remat=remat))


def _worker_cfg(name, bn, remat=False):
    world, (d, m), _, _ = CASES[name]
    cfg = _case_cfg(name, _port_cfg, BN_PATHS[bn], remat)
    return cfg.replace(mesh=torch_config.MeshConfig(d, m))


def _start(world, tmp, student, teacher):
    cases = {f"{c}-{b}": json.loads(_worker_cfg(c, b).to_json())
             for c, b in RUNS if CASES[c][0] == world}
    if CASES[REMAT[0]][0] == world:
        cases["remat"] = json.loads(_worker_cfg(*REMAT, remat=True).to_json())
    torch.save({"student": student, "teacher": teacher, "cases": cases},
               tmp / "init.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(world), "--master_addr", "localhost", "--master_port",
           str(_free_port()), str(WORKER), "--init", str(tmp / "init.pt"),
           "--out", str(tmp / "out.pt")]
    if world == 4:
        cmd += ["--ckdir", str(tmp / "cli"), "--cli", CLI]
    return subprocess.Popen(cmd, env=env, cwd=tmp, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(world, tmp, proc, timeout=240):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0, stdout[-3000:] + stderr[-5000:]
    out = torch.load(tmp / "out.pt", weights_only=False)
    out["checks"] = [torch.load(tmp / f"out.pt.{k}") for k in range(world)]
    out["tmp"] = tmp
    return out


def _jax_step(name, jax_weights):
    """The JAX package's step of case ``name`` on its (data, model) mesh of
    the concatenated batch (its BN runs the plain reference on the CPU):
    the state dict after it, in the port's layout, and its metrics."""
    variables, t_vars = jax_weights
    mesh = CASES[name][1]
    batch = JaxEpisodeBatch(*_one_process_batch(_case_cfg(name, _port_cfg),
                                                mesh[0]))
    new, jm = _jax_student_step(_case_cfg(name, _jax_cfg), variables, t_vars,
                                batch, mesh)
    return (student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
        _port_cfg()), {k: float(v) for k, v in jm.items()})


@pytest.fixture(scope="module")
def results(jax_weights, tmp_path_factory):
    """Both worlds' workers, started together, and the JAX steps of every
    case, computed while they run."""
    student, teacher = _port_weights(*jax_weights)
    runs = {}
    for w in (2, 4):
        tmp = tmp_path_factory.mktemp(f"spans{w}")
        runs[w] = (tmp, _start(w, tmp, student, teacher))
    jax_steps = {name: _jax_step(name, jax_weights) for name in CASES}
    return {w: _finish(w, tmp, proc) for w, (tmp, proc) in runs.items()}, \
        jax_steps


@pytest.fixture(scope="module")
def worlds(results):
    return results[0]


@pytest.fixture(scope="module")
def jax_steps(results):
    return results[1]


def _got(worlds, name, bn):
    return worlds[CASES[name][0]]["cases"][f"{name}-{bn}"]


@pytest.mark.parametrize("name,bn", RUNS)
def test_step_equals_jax_sharded(worlds, jax_steps, name, bn):
    """The ranks' step against the JAX package's on the (data, model)
    mesh (JAX's own sharded bounds, rtol 2e-3 and atol 1e-5): task loss,
    accuracy, every parameter and running statistic after the SGD
    update."""
    want, jm = jax_steps[name]
    got = _got(worlds, name, bn)
    (m,) = got["metrics"]
    for k in ("task_loss", "accuracy"):
        assert m[k] == pytest.approx(jm[k], rel=2e-3, abs=1e-5), k
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "pe.pe")):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,bn", RUNS)
def test_step_equals_one_process(worlds, jax_weights, name, bn):
    """The same step against the port's one-process step on the replicas'
    shards concatenated: loss and metrics (rel 1e-4), every parameter,
    running statistic and update count (rtol 1e-4, atol 1e-6), and every
    gradient within 2e-4 of the largest (a spanning chunk sums its BN
    moments in another order, the bound of
    ``tests/test_torch_port_parallel.py``)."""
    cfg = _case_cfg(name, _port_cfg, BN_PATHS[bn])
    state, want = _one_process_step(cfg, jax_weights, CASES[name][1][0])
    got = _got(worlds, name, bn)
    _assert_step(got, state, want, span=True)
    assert got["episodes_seen"] == CASES[name][2]


def test_remat_step_equals_one_process(worlds, jax_weights):
    """Uneven pieces with per-block remat (the recompute takes the same
    synchronised moments and keeps no running-statistics update) equal
    the one-process remat step, as above."""
    name, bn = REMAT
    cfg = _case_cfg(name, _port_cfg, BN_PATHS[bn], remat=True)
    state, want = _one_process_step(cfg, jax_weights, CASES[name][1][0])
    _assert_step(worlds[CASES[name][0]]["cases"]["remat"], state, want, span=True)


@pytest.mark.parametrize("name", list(CASES))
def test_rank0_pieces_follow_the_plan(worlds, name):
    """Rank 0 ran the pieces of data index 0, and at least one chunk lies
    across replicas; no kernel launched on the CPU."""
    _, (d, _), tpb, micro = CASES[name]
    for bn in BN_PATHS:
        got = _got(worlds, name, bn)
        plan = chunk_plan(micro, tpb, d, 0)
        assert got["pieces"] == [tuple(p[:4]) + (tuple(p.members),) for p in plan]
        assert got["launches"] == [0, 0, 0]
    spans = [len(p.members) for i in range(d) for p in chunk_plan(micro, tpb, d, i)]
    assert max(spans) == 2


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree(worlds, world):
    """Every rank ends each case with the same student (checksums)."""
    checks = worlds[world]["checks"]
    assert all(c == checks[0] for c in checks), checks


def test_cli_partial_span_trains_and_writes_from_rank_0(worlds):
    """``cli.train --mesh_data 4 --tasks_per_batch 8 --micro_batch 4``:
    chunks of two ranks train, and rank 0 alone writes the checkpoint."""
    ck = worlds[4]["tmp"] / "cli"
    names = sorted(os.listdir(ck))
    assert [n for n in names if n.endswith(".pt")] == ["checkpoint_8.pt"]
    assert "config.json" in names
    sd = torch.load(ck / "checkpoint_8.pt", weights_only=True)
    assert sd["episodes_seen"] == 8 and sd["step"] == 1

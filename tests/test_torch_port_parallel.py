"""The port's scale-out (``litemkd_torch/parallel``) against the JAX
package's: mesh layouts and their errors, each rank's episode stream, and
data-parallel training and eval over a gloo process group of two ranks on
the CPU, held against the port's one-process step on the ranks' shards
concatenated and, for the spanning-chunk layout, against the JAX package's
``data``-sharded step on a (data 2, model 1) mesh.

The ranks run in ``tests/torch_parallel_worker.py`` under
``torch.distributed.run`` (a free port; a 120 s limit, so that a hang fails
the test). Tiny preset, fp32, dropout 0, numpy-seeded inputs; every
BatchNorm bias starts at +3 as in ``tests/test_torch_port_train.py`` (a
pre-activation is then rarely at the ReLU kink, where a last-bit
difference would flip a mask)."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.parallel import (host_rng as jax_host_rng,
                                  make_mesh as jax_make_mesh,
                                  shard_batch as jax_shard_batch,
                                  shard_variables)
from litemkd_tpu.train.schedule import make_optimizer as jax_make_optimizer
from litemkd_tpu.train.steps import (TrainState as JaxTrainState,
                                     create_train_state as jax_create_state,
                                     make_train_step as jax_make_train_step)
import litemkd_torch.config as torch_config
from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.models import BatchedTeacher
from litemkd_torch.parallel import (DataParallel, Mesh, host_rng,
                                    local_episode_count, make_mesh, shard_batch)
from litemkd_torch.parallel.data_parallel import (chunk_plan, chunk_spans,
                                                  span_groups)
from litemkd_torch.tools.weights import (student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from litemkd_torch.train import (create_mfm_train_state, create_train_state,
                                 make_mfm_train_step, make_train_step, run_eval,
                                 to_device)

from torch_parallel_worker import MetaSource, concat_batches

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"
SEED_STEP = 0

torch.set_num_threads(2)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# (g) the layout and the streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,model,world", [
    (-1, 1, 2), (2, 1, 2), (1, 2, 2), (-1, 2, 4), (4, 1, 4), (-1, 1, 1),
    (-1, 3, 4), (3, 1, 4), (2, 2, 2)])
def test_make_mesh_equals_jax(data, model, world):
    """Shapes and error messages of the port's make_mesh over ``world``
    ranks equal JAX's make_mesh over ``world`` devices."""
    devices = jax.devices()[:world]
    try:
        want = dict(jax_make_mesh(jax_config.MeshConfig(data, model), devices).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(torch_config.MeshConfig(data, model), world)
        assert str(got.value) == str(e)
        return
    got = make_mesh(torch_config.MeshConfig(data, model), world)
    assert got.shape == want and got.size == world


def _pieces(micro, episodes, data):
    """Each data index's pieces as (chunk, start, stop, members)."""
    return [[(p.chunk, p.start, p.stop, tuple(p.members))
             for p in chunk_plan(micro, episodes, data, d)] for d in range(data)]


def test_local_episode_count_and_layouts():
    """The chunk plan: each replica's pieces of the chunks (global episode
    ranges) with the data indices of their chunk, and the process groups
    that the spans of several replicas get."""
    assert local_episode_count(16, 4) == 4
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4"):
        local_episode_count(6, 4)
    # one chunk over every replica (micro 0, or at least the batch)
    assert _pieces(0, 4, 2) == _pieces(4, 4, 2) == [[(0, 0, 2, (0, 1))],
                                                   [(0, 2, 4, (0, 1))]]
    # chunks inside each replica; the flagship at world 4
    assert _pieces(2, 8, 2) == [[(0, 0, 2, (0,)), (1, 2, 4, (0,))],
                                [(2, 4, 6, (1,)), (3, 6, 8, (1,))]]
    assert [len(p) for p in _pieces(4, 16, 4)] == [1, 1, 1, 1]
    # each chunk over two replicas: E 8 over 4, the flagship's 16 over 8
    assert _pieces(4, 8, 4) == [[(0, 0, 2, (0, 1))], [(0, 2, 4, (0, 1))],
                                [(1, 4, 6, (2, 3))], [(1, 6, 8, (2, 3))]]
    assert chunk_spans(4, 16, 8) == [range(2 * i, 2 * i + 2) for i in range(4)]
    # chunks off the replicas' boundaries
    assert _pieces(2, 6, 2) == [[(0, 0, 2, (0,)), (1, 2, 3, (0, 1))],
                                [(1, 3, 4, (0, 1)), (2, 4, 6, (1,))]]
    assert _pieces(4, 12, 4) == [
        [(0, 0, 3, (0, 1))], [(0, 3, 4, (0, 1)), (1, 4, 6, (1, 2))],
        [(1, 6, 8, (1, 2)), (2, 8, 9, (2, 3))], [(2, 9, 12, (2, 3))]]

    made = []

    def rank(data, model, model_index):
        """What ``span_groups`` reads of a rank at ``model_index``."""
        return SimpleNamespace(data=data, model=model, model_index=model_index,
                               data_group="data", layout=Mesh(data, model))

    def new_group(ranks):
        made.append(ranks)
        return f"group{len(made)}"

    mp = pytest.MonkeyPatch()
    mp.setattr(torch.distributed, "new_group", new_group)
    try:
        groups = span_groups(rank(4, 1, 0), chunk_spans(4, 12, 4))
        assert made == [[0, 1], [1, 2], [2, 3]]
        assert groups == {range(0, 2): "group1", range(1, 3): "group2",
                          range(2, 4): "group3"}
        # a span of every replica is the data group; single ones get none
        assert span_groups(rank(4, 1, 0), chunk_spans(0, 8, 4)) == {
            range(0, 4): "data"}
        assert span_groups(rank(4, 1, 0), chunk_spans(2, 8, 4)) == {}
        assert span_groups(rank(2, 2, 1), chunk_spans(2, 6, 2)) == {
            range(0, 2): "data"}
        assert len(made) == 3
        # with a model axis each span is made at every model index, and a
        # rank keeps its own model index's
        del made[:]
        groups = span_groups(rank(4, 2, 1), chunk_spans(4, 12, 4))
        assert made == [[0, 2], [1, 3], [2, 4], [3, 5], [4, 6], [5, 7]]
        assert groups[range(1, 3)] == "group4"
    finally:
        mp.undo()


def _jax_cfg(**train):
    jcfg = jax_config.preset("tiny")
    return jcfg.replace(
        model=dataclasses.replace(jcfg.model, compute_dtype="float32",
                                  trans_dropout=0.0),
        data=dataclasses.replace(jcfg.data, synthetic_noise=2.0),
        train=dataclasses.replace(jcfg.train, **train))


def _port_cfg(**train):
    cfg = torch_config.preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                  trans_dropout=0.0),
        data=dataclasses.replace(cfg.data, synthetic_noise=2.0),
        train=dataclasses.replace(cfg.train, **train))


@pytest.mark.parametrize("rank", [0, 1])
def test_host_rng_shards_equal_jax(monkeypatch, rank):
    """Rank r's episodes of a step are byte for byte JAX process r's."""
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    jcfg, cfg = _jax_cfg(), _port_cfg()
    jsrc = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=2.0)
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed, noise=2.0)
    want = jsrc.sample_batch(jax_host_rng(jcfg.train.seed, 5), 2, train=True)
    got = src.sample_batch(host_rng(cfg.train.seed, rank, 5), 2, train=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert host_rng(7, rank).integers(1 << 30) == \
        jax_host_rng(7).integers(1 << 30)


# ---------------------------------------------------------------------------
# (h)-(j) two ranks against one process
# ---------------------------------------------------------------------------

# name → (train settings, BN-moment kernel path)
SCENARIOS = {
    "span": (dict(tasks_per_batch=4, micro_batch=0), False),
    "span_kernel": (dict(tasks_per_batch=4, micro_batch=0), True),
    "local": (dict(tasks_per_batch=8, micro_batch=2), True),
}


def _shift_bn_bias(tree, path=()):
    if isinstance(tree, dict):
        return {k: _shift_bn_bias(v, path + (k,)) for k, v in tree.items()}
    if path[-1] == "bias" and "bn" in path[-2]:
        return tree + np.float32(3.0)
    return tree


def _scenario_cfg(name, module):
    train, pallas_bn = SCENARIOS[name]
    cfg = module(training_iterations=train["tasks_per_batch"], test_iters=(),
                 print_freq=0, **train)
    return cfg.replace(model=dataclasses.replace(cfg.model, pallas_bn=pallas_bn))


@pytest.fixture(scope="module")
def jax_weights():
    jcfg = _jax_cfg()
    src = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=2.0)
    state, t_vars = jax_create_state(jcfg, jax.random.key(0),
                                     src.sample_batch(np.random.default_rng(0), 1),
                                     episodes_per_step=4)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    variables["params"] = _shift_bn_bias(variables["params"])
    return variables, jax.tree_util.tree_map(np.asarray, t_vars)


def _port_weights(variables, t_vars):
    cfg = _port_cfg()
    teacher = teacher_state_dict_from_reference(
        teacher_state_dict_from_jax(t_vars, cfg), BatchedTeacher(cfg))
    return student_state_dict_from_jax(variables, cfg), teacher


def _mfm_cfg():
    cfg = _port_cfg(tasks_per_batch=4, training_iterations=4, test_iters=(),
                    print_freq=0)
    return cfg


@pytest.fixture(scope="module")
def world2(jax_weights, tmp_path_factory):
    """The worker's results: two ranks under torch.distributed.run."""
    tmp = tmp_path_factory.mktemp("world2")
    student, teacher = _port_weights(*jax_weights)
    torch.save({"student": student, "teacher": teacher,
                "scenarios": {n: json.loads(_scenario_cfg(n, _port_cfg).to_json())
                              for n in SCENARIOS},
                "mfm": json.loads(_mfm_cfg().to_json())}, tmp / "init.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           str(WORKER), "--init", str(tmp / "init.pt"),
           "--out", str(tmp / "out.pt"), "--ckdir", str(tmp / "cli")]
    r = subprocess.run(cmd, env=env, cwd=tmp, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-5000:]
    out = torch.load(tmp / "out.pt", weights_only=False)
    out["rank_sums"] = [torch.load(tmp / f"out.pt.{k}") for k in (0, 1)]
    out["tmp"], out["stdout"] = tmp, r.stdout
    return out


def _one_process_batch(cfg, world=2):
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=cfg.data.synthetic_noise)
    e = local_episode_count(cfg.train.tasks_per_batch, world)
    return concat_batches([src.sample_batch(host_rng(cfg.train.seed, r, SEED_STEP),
                                            e, train=True) for r in range(world)])


def _one_process_step(name, jax_weights):
    cfg = _scenario_cfg(name, _port_cfg)
    student, teacher = _port_weights(*jax_weights)
    state = create_train_state(cfg, "cpu", student_state_dict=student,
                               teacher_state_dict=teacher)
    metrics = make_train_step(cfg)(state, to_device(_one_process_batch(cfg), "cpu"))
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_world2_step_equals_one_process(world2, jax_weights, name):
    """Loss, every parameter and BN running statistic (rtol 1e-4, atol
    1e-6) and the summed gradient of the plain SGD update after one
    data-parallel step of two ranks equal the one-process step on the
    ranks' shards concatenated: the spanning chunk through synchronised
    moments (plain sums and the kernel path), the chunks inside each rank
    through the EMA rebuilt from both ranks' chains.

    Gradients: rtol 1e-4 and atol 1e-6·max|g| where each chunk's
    arithmetic is the same in both runs ("local"). A spanning chunk runs
    its convolutions at another batch size and its BN sums in another
    order, and the fp32 rounding of that moves the stem's gradient by up
    to 7e-5·max|g| (measured); with the BN math in float64 the two agree
    within 1e-6·max|g|. So atol 2e-4·max|g| there, the bound the port's
    one-process step is held to against JAX
    (``tests/test_torch_port_train.py``)."""
    got = world2["scenarios"][name]
    state, want = _one_process_step(name, jax_weights)
    assert got["episodes_seen"] == state.episodes_seen
    (m,) = got["metrics"]
    for k, v in want.items():
        assert m[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    sd = state.model.state_dict()
    assert set(got["state_dict"]) == set(sd)
    for k, v in sd.items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    assert set(grads) == set(got["grads"]) and len(grads) == 64 + 6
    g_max = max(float(g.abs().max()) for g in grads.values())
    g_tol = 2e-4 if name.startswith("span") else 1e-6
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-4, atol=g_tol * g_max, err_msg=k)


def test_world2_ranks_agree(world2):
    a, b = world2["rank_sums"]
    assert a == b


def test_world2_span_step_equals_jax_sharded(world2, jax_weights):
    """The two ranks' spanning-chunk step against the JAX package's step on
    a (data 2, model 1) mesh of the concatenated batch (JAX's own sharded
    bounds, rtol 2e-3 and atol 1e-5): task loss, accuracy, every parameter
    and running statistic after the SGD update."""
    variables, t_vars = jax_weights
    jcfg = _scenario_cfg("span", _jax_cfg)
    tpb = jcfg.train.tasks_per_batch
    jsrc = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=2.0)
    batch = concat_batches([jsrc.sample_batch(
        np.random.default_rng((jcfg.train.seed, r, SEED_STEP)), tpb // 2,
        train=True) for r in range(2)])
    mine = _one_process_batch(_scenario_cfg("span", _port_cfg))
    assert all(np.array_equal(a, b) for a, b in zip(batch, mine))
    mesh = jax_make_mesh(jax_config.MeshConfig(data=2, model=1), jax.devices()[:2])
    t = jcfg.train
    tx = jax_make_optimizer(t.optimizer, t.learning_rate, t.sch, t.sch_gamma, tpb)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    state = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                          episodes_seen=jax.numpy.zeros((), jax.numpy.int32),
                          params=params, batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), rng=jax.random.key(1), tx=tx)
    state = state.replace(params=shard_variables(state.params, mesh),
                          batch_stats=shard_variables(state.batch_stats, mesh),
                          opt_state=shard_variables(state.opt_state, mesh))
    with jax.set_mesh(mesh):
        new, jm = jax.jit(jax_make_train_step(jcfg))(
            state, shard_variables(t_vars, mesh), jax_shard_batch(batch, mesh))
    (m,) = world2["scenarios"]["span"]["metrics"]
    for k in ("task_loss", "accuracy"):
        assert m[k] == pytest.approx(float(jm[k]), rel=2e-3, abs=1e-5), k
    want = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
        _port_cfg())
    got = world2["scenarios"]["span"]["state_dict"]
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "pe.pe")):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-5, err_msg=k)


def test_world2_eval_equals_one_process(world2):
    """The sharded eval (n_tasks 20 rounded to 16: two chunks of 8, 4 a
    rank) gives a one-process eval's summary (within 1e-4) and per-task
    records, in task order."""
    cfg = _scenario_cfg("span", _port_cfg)
    student = create_train_state(cfg, "cpu", with_teacher=False).model
    student.load_state_dict(world2["eval_model"])
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=cfg.data.synthetic_noise)
    records = []
    want = run_eval(cfg, student.eval(), MetaSource(src), n_tasks=16,
                    batch_size=8, seed=0, task_log=records.append)
    got = world2["eval"]
    assert got["n_tasks"] == want["n_tasks"] == 16
    for k in ("accuracy", "confidence"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert [r["task"] for r in world2["eval_records"]] == list(range(16))
    for a, b in zip(world2["eval_records"], records):
        assert a["classes"] == b["classes"] and a["real_preds"] == b["real_preds"]
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)
    assert "rounding n_tasks 20 → 16" in world2["stdout"]


def test_world2_mfm_step_equals_one_process(world2):
    """One data-parallel MFM step of two ranks (summed gradients) equals
    the one-process step on the concatenated batch."""
    cfg = _mfm_cfg()
    state = create_mfm_train_state(cfg, "cpu")
    src = SyntheticMultiModalSource(cfg, seed=cfg.train.seed)
    batch = concat_batches([src.sample_batch(host_rng(cfg.train.seed, r, 0), 2)
                            for r in range(2)])
    want = make_mfm_train_step(cfg)(state, to_device(batch, "cpu"))
    got = world2["mfm"]
    assert got["episodes_seen"] == state.episodes_seen == 4
    (m,) = got["metrics"]
    for k, v in want.items():
        assert m[k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_world2_cli_train_writes_from_rank_0(world2):
    """``cli.train --mesh_data 2`` under torch.distributed.run trains and
    rank 0 alone writes the checkpoint, config.json and the logs."""
    ck = world2["tmp"] / "cli"
    names = sorted(os.listdir(ck))
    assert [n for n in names if n.endswith(".pt")] == ["checkpoint_4.pt"]
    assert "config.json" in names
    assert len([n for n in names if n.endswith(".jsonl")]) == 1
    sd = torch.load(ck / "checkpoint_4.pt", weights_only=True)
    assert sd["episodes_seen"] == 4 and sd["step"] == 2


def test_world2_mesh_not_laying_out_world_raises(world2):
    """A ``model`` axis that does not divide the world (3 at world 2)
    raises JAX's ``make_mesh`` error from ``setup_data_parallel``."""
    with pytest.raises(ValueError) as e:
        jax_make_mesh(jax_config.MeshConfig(-1, 3), jax.devices()[:2])
    assert world2["mesh_error"] == str(e.value)


def test_micro_chunks_reject_partial_spans():
    """Only what the JAX package refuses is refused before any step: a
    ``micro_batch`` that does not divide the batch (and a batch that does
    not divide over the replicas); every chunk over some replicas but not
    all is planned."""
    dp = DataParallel(0, 4, torch.device("cpu"))     # no group is made
    for tpb, micro in ((8, 3), (12, 5), (6, 4)):
        with pytest.raises(ValueError, match=f"micro_batch {micro} does not "
                                             f"divide the {tpb} episodes"):
            make_train_step(_port_cfg(tasks_per_batch=tpb, micro_batch=micro),
                            dp)
        with pytest.raises(ValueError, match="does not divide"):
            chunk_plan(micro, tpb)
    with pytest.raises(ValueError, match="global batch 6 not divisible by 4"):
        make_train_step(_port_cfg(tasks_per_batch=6, micro_batch=2), dp)
    for tpb, micro, data in ((8, 4, 4), (12, 4, 4), (6, 2, 2), (12, 4, 2),
                             (16, 4, 8), (24, 8, 6), (6, 3, 3)):
        pieces = [p for d in range(data) for p in chunk_plan(micro, tpb, data, d)]
        assert sorted((p.start, p.stop) for p in pieces) == [
            (p.start, p.stop) for p in pieces]
        assert sum(p.episodes for p in pieces) == tpb
        assert any(len(p.members) > 1 and p.size < tpb for p in pieces)

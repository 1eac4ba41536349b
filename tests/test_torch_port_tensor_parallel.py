"""The port's ``model`` (tensor-parallel) mesh axis against the JAX
package's: which parameters are sharded, the column and row layers, and
training and eval over gloo process groups on the CPU at (data 1, model 2),
(2, 2) and (1, 4), held against the port's one-process step on the
replicas' shards concatenated and against the JAX package's step on a
(data, model) virtual CPU mesh.

The ranks run in ``tests/torch_tensor_parallel_worker.py`` under
``torch.distributed.run``, once at world 2 and once at world 4 (both of its
meshes in one group). Tiny preset, fp32, dropout 0 except where stated,
numpy-seeded inputs, every BatchNorm bias at +3 as in
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

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli.train_teacher import \
    SyntheticMultiModalSource as JaxMultiModalSource
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.parallel import (make_mesh as jax_make_mesh,
                                  shard_batch as jax_shard_batch,
                                  shard_variables, variables_shardings)
from litemkd_tpu.train import (create_mfm_train_state as jax_create_mfm_state,
                               make_mfm_train_step as jax_make_mfm_step)
from litemkd_tpu.train.schedule import make_optimizer as jax_make_optimizer
from litemkd_tpu.train.steps import (EpisodeBatch as JaxEpisodeBatch,
                                     TrainState as JaxTrainState,
                                     create_train_state as jax_create_state,
                                     make_train_step as jax_make_train_step)
import litemkd_torch.config as torch_config
from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.models import BatchedStudent, BatchedTeacher
from litemkd_torch.parallel import (Mesh, ModelAxis, host_rng,
                                    local_episode_count, shard_model,
                                    sharded_parameters)
from litemkd_torch.tools.weights import (mfm_state_dict_from_jax,
                                         student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from litemkd_torch.train import (create_mfm_train_state, create_train_state,
                                 make_mfm, make_mfm_train_step, make_train_step,
                                 run_eval, to_device)

from test_torch_port_parallel import (_free_port, _jax_cfg, _port_cfg,
                                      _port_weights, jax_weights)  # noqa: F401
from torch_parallel_worker import MetaSource, concat_batches

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_tensor_parallel_worker.py"
WORLDS = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
CLI_MESH = {2: (1, 2), 4: (2, 2)}
MESHES = [m for ms in WORLDS.values() for m in ms]

torch.set_num_threads(2)

# name → (train settings, BN-moment kernel path): a chunk spanning every
# replica, and chunks inside each replica with the watched norms (each
# shard counted once)
SCENARIOS = {
    "span": (dict(tasks_per_batch=4, micro_batch=0), False),
    "local": (dict(tasks_per_batch=8, micro_batch=2, watch=True), True),
}


def _scenario_cfg(name, module, dropout=0.0):
    train, pallas_bn = SCENARIOS[name]
    cfg = module(training_iterations=train["tasks_per_batch"], test_iters=(),
                 print_freq=0, **train)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, pallas_bn=pallas_bn, trans_dropout=dropout))


def _mfm_cfg(make):
    """The tiny MFM geometry of ``tests/test_sharding.py`` (in 32, out 16,
    one encoder layer), 4 episodes a step, SGD at 1e-2 so that the update
    shows."""
    base = make("tiny")
    return base.replace(
        model=dataclasses.replace(base.model, trans_linear_in_dim=32,
                                  trans_linear_out_dim=16, trans_num=1,
                                  trans_dropout=0.0, compute_dtype="float32"),
        train=dataclasses.replace(base.train, tasks_per_batch=4,
                                  training_iterations=4, learning_rate=1e-2,
                                  test_iters=(), print_freq=0))


def _cfg_json(cfg):
    return json.loads(cfg.to_json())


# ---------------------------------------------------------------------------
# which parameters are sharded: the port's rules against JAX's
# ---------------------------------------------------------------------------

def _flags(tree, m):
    """A tree of the shapes of ``tree`` holding 1.0 on the leaves that
    JAX's ``variables_shardings`` cuts over ``model`` (m = 0: none) and 0.0
    elsewhere."""
    if m == 0:
        return jax.tree_util.tree_map(
            lambda x: np.zeros(np.shape(x), np.float32), tree)
    mesh = jax_make_mesh(jax_config.MeshConfig(1, m), jax.devices()[:m])
    sh = variables_shardings(tree, mesh)
    return jax.tree_util.tree_map(
        lambda x, s: np.full(np.shape(x), float("model" in str(s.spec)),
                             np.float32), tree, sh)


def _hit(convert, m, model):
    """The parameters of ``model`` that ``convert(_flags(·, m))`` lights:
    those that differ from the conversion of the all-zero tree (a
    converter fills some parameters that JAX lacks, such as ``norm_v``)."""
    params = dict(model.named_parameters())
    lit, dark = convert(m), convert(0)
    return sorted(k for k, v in lit.items()
                  if k in params and not torch.equal(v, dark[k]))


def _port_sharded(model, m):
    shard_model(model, ModelAxis(None, m, 0))
    return sorted(sharded_parameters(model))


@pytest.fixture(scope="module")
def jax_trees():
    """JAX variables of the student and teacher of ``student_fc2sup_dist``
    (at the tiny widths), of ``student_mobilenet`` and of the MFM."""
    out = {}
    for name, backbone in (("student_fc2sup_dist", "resnet18_2fc"),
                           ("student_mobilenet", "mobilenetv3_large_2fc")):
        jcfg, cfg = _jax_cfg(), _port_cfg()
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                      backbone=backbone))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    backbone=backbone))
        batch = JaxSource(jcfg, n_classes=16, seed=0, noise=2.0).sample_batch(
            np.random.default_rng(0), 1)
        # the shapes are all the rules read
        state, t_vars = jax.eval_shape(lambda: jax_create_state(
            jcfg, jax.random.key(0), batch, episodes_per_step=4))
        out[name] = (cfg, {"params": state.params,
                           "batch_stats": state.batch_stats}, t_vars)
    jcfg = _mfm_cfg(jax_config.preset)
    src = JaxMultiModalSource(jcfg, n_classes=8, seed=0)
    state = jax_create_mfm_state(jcfg, jax.random.key(0),
                                 src.sample_batch(np.random.default_rng(0), 2))
    out["mfm"] = (_mfm_cfg(torch_config.preset), {"params": state.params}, None)
    return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("family", ["student_fc2sup_dist", "teacher",
                                    "student_mobilenet", "mfm"])
def test_sharded_parameters_equal_jax(jax_trees, family, m):
    """The port's sharded parameters are the JAX rules' (``param_spec``
    with the divisibility fallback): JAX's converter, fed 1.0 on the leaves
    that ``variables_shardings`` cuts over ``model`` and 0.0 elsewhere,
    lights exactly the port's sharded parameters."""
    key = "student_fc2sup_dist" if family == "teacher" else family
    cfg, variables, t_vars = jax_trees[key]
    if family == "mfm":
        model = make_mfm(cfg)
        want = _hit(lambda k: mfm_state_dict_from_jax(
            {"params": _flags(variables["params"], k)}, cfg), m, model)
    elif family == "teacher":
        model = BatchedTeacher(cfg)
        want = _hit(lambda k: teacher_state_dict_from_reference(
            teacher_state_dict_from_jax(_flags(t_vars, k), cfg),
            BatchedTeacher(cfg)), m, model)
    else:
        model = BatchedStudent(cfg)
        want = _hit(lambda k: student_state_dict_from_jax(
            _flags(variables, k), cfg), m, model)
    assert want, family
    assert _port_sharded(model, m) == want


def test_mesh_coords_follow_jax_device_grid():
    """Rank r sits where JAX's ``make_mesh`` puts device r: data index
    r // model, model index r % model; a model group is consecutive."""
    for d, m in [(2, 2), (1, 4), (4, 2), (2, 4), (8, 1)]:
        devices = jax.devices()[:d * m]
        grid = jax_make_mesh(jax_config.MeshConfig(d, m), devices).devices
        mesh = Mesh(d, m)
        for r, dev in enumerate(devices):
            i, j = mesh.coords(r)
            assert grid[i, j] == dev
            assert r in mesh.model_ranks(i) and r in mesh.data_ranks(j)


# ---------------------------------------------------------------------------
# the worker's runs
# ---------------------------------------------------------------------------

def _mfm_weights(jax_trees):
    _, variables, _ = jax_trees["mfm"]
    return mfm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables),
                                   _mfm_cfg(torch_config.preset))


def start_worker(world, tmp, student, teacher, mfm_state, device="cpu"):
    """Start the worker over ``world`` ranks; ``finish_worker`` waits."""
    torch.save({"student": student, "teacher": teacher,
                "meshes": WORLDS[world], "cli_mesh": CLI_MESH[world],
                "scenarios": {n: _cfg_json(_scenario_cfg(n, _port_cfg))
                              for n in SCENARIOS},
                "dropout": _cfg_json(_scenario_cfg("span", _port_cfg, 0.1)),
                "mfm": _cfg_json(_mfm_cfg(torch_config.preset)),
                "mfm_state": mfm_state}, tmp / "init.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(world), "--master_addr", "localhost", "--master_port",
           str(_free_port()), str(WORKER), "--init", str(tmp / "init.pt"),
           "--out", str(tmp / "out.pt"), "--ckdir", str(tmp / "cli"),
           "--device", device]
    proc = subprocess.Popen(cmd, env=env, cwd=tmp, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return world, tmp, proc


def finish_worker(world, tmp, proc, timeout=240):
    """What rank 0 saw, with every rank's checksums under ``"checks"``."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0, stdout[-3000:] + stderr[-5000:]
    out = torch.load(tmp / "out.pt", weights_only=False)
    out["checks"] = [torch.load(tmp / f"out.pt.{k}") for k in range(world)]
    out["tmp"], out["stdout"] = tmp, stdout
    return out


@pytest.fixture(scope="module")
def worlds(jax_weights, jax_trees, tmp_path_factory):
    """Both worlds' workers, started together."""
    student, teacher = _port_weights(*jax_weights)
    mfm_state = _mfm_weights(jax_trees)
    runs = {w: start_worker(w, tmp_path_factory.mktemp(f"world{w}"), student,
                            teacher, mfm_state) for w in WORLDS}
    return {w: finish_worker(*run) for w, run in runs.items()}


def _mesh_result(worlds, mesh):
    world = mesh[0] * mesh[1]
    return worlds[world]["meshes"][mesh]


def _one_process_batch(cfg, data):
    """The global batch of ``data`` replicas (one replica: the one-process
    stream)."""
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=cfg.data.synthetic_noise)
    tpb = cfg.train.tasks_per_batch
    if data == 1:
        return src.sample_batch(np.random.default_rng((cfg.train.seed, 0)),
                                tpb, train=True)
    e = local_episode_count(tpb, data)
    return concat_batches([src.sample_batch(host_rng(cfg.train.seed, d, 0), e,
                                            train=True) for d in range(data)])


def _one_process_step(cfg, jax_weights, data):
    student, teacher = _port_weights(*jax_weights)
    state = create_train_state(cfg, "cpu", student_state_dict=student,
                               teacher_state_dict=teacher)
    metrics = make_train_step(cfg)(state, to_device(_one_process_batch(cfg, data),
                                                    "cpu"))
    return state, {k: float(v) for k, v in metrics.items()}


def _assert_step(got, state, want, span):
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
    assert set(grads) == set(got["grads"])
    g_max = max(float(g.abs().max()) for g in grads.values())
    # a spanning chunk sums its BN moments in another order (the bound of
    # tests/test_torch_port_parallel.py); chunks inside a replica differ by
    # the model group's sum of the column layers' partial input gradients,
    # whose fp32 rounding reaches the stem at up to 2e-6·max|g| (measured)
    g_tol = 2e-4 if span else 1e-5
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-4, atol=g_tol * g_max, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES)
def test_layers_equal_linear(worlds, mesh):
    """A lone column layer (gathered) and a column → ReLU → row pair equal
    their ``nn.Linear``s: outputs, the input's gradient (the column layers'
    backward all-reduce) and the weights' gradients."""
    got = _mesh_result(worlds, mesh)["layers"]
    ref, tp = got["linear"], got["tp"]
    for k in ("y", "z", "dx"):
        np.testing.assert_allclose(tp[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert set(tp["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(tp["grads"][k].numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in ref["state"].items():
        assert torch.equal(tp["state"][k], v), k


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("mesh", MESHES)
def test_student_step_equals_one_process(worlds, jax_weights, mesh, name):
    """One step of the student at (data, model): loss and metrics, every
    parameter and running statistic (rtol 1e-4, atol 1e-6) and every
    gradient, gathered to the one-process layout, equal the one-process
    step on the replicas' shards concatenated. The student and the frozen
    teacher are sharded by the JAX rules."""
    got = _mesh_result(worlds, mesh)["scenarios"][name]
    cfg = _scenario_cfg(name, _port_cfg)
    state, want = _one_process_step(cfg, jax_weights, mesh[0])
    _assert_step(got, state, want, span=name == "span")
    assert "classifier.transformers.k_linear.weight" in got["sharded"]
    assert "backbone.fc1.weight" in got["sharded"]
    assert got["teacher_sharded"] == [
        "classifier.transformers.k_linear.weight",
        "classifier.transformers.v_linear.weight"]


def test_dropout_step_equals_one_process(worlds, jax_weights):
    """At dropout 0.1 the model group draws every mask at full width from
    the shared generator, so a (1, 2) step equals the one-process step."""
    got = _mesh_result(worlds, (1, 2))["scenarios"]["dropout"]
    cfg = _scenario_cfg("span", _port_cfg, 0.1)
    state, want = _one_process_step(cfg, jax_weights, 1)
    _assert_step(got, state, want, span=True)


def _jax_student_step(jcfg, variables, t_vars, batch, mesh_shape):
    d, m = mesh_shape
    mesh = jax_make_mesh(jax_config.MeshConfig(data=d, model=m),
                         jax.devices()[:d * m])
    t = jcfg.train
    tx = jax_make_optimizer(t.optimizer, t.learning_rate, t.sch, t.sch_gamma,
                            t.tasks_per_batch)
    params = jax.tree_util.tree_map(jax.numpy.asarray, variables["params"])
    state = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                          episodes_seen=jax.numpy.zeros((), jax.numpy.int32),
                          params=params, batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), rng=jax.random.key(1), tx=tx)
    state = state.replace(params=shard_variables(state.params, mesh),
                          batch_stats=shard_variables(state.batch_stats, mesh),
                          opt_state=shard_variables(state.opt_state, mesh))
    with jax.set_mesh(mesh):
        return jax.jit(jax_make_train_step(jcfg))(
            state, shard_variables(t_vars, mesh), jax_shard_batch(batch, mesh))


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.parametrize("mesh", MESHES)
def test_student_step_equals_jax_sharded(worlds, jax_weights, mesh, name):
    """The same step against the JAX package's on a (data, model) mesh of
    the concatenated batch (JAX's sharded bounds, rtol 2e-3 and atol 1e-5):
    task loss, accuracy, every parameter and running statistic after the
    SGD update. (JAX's BN runs its plain reference on the CPU.)"""
    variables, t_vars = jax_weights
    jcfg = _scenario_cfg(name, _jax_cfg)
    batch = _one_process_batch(_scenario_cfg(name, _port_cfg), mesh[0])
    batch = JaxEpisodeBatch(*batch)
    new, jm = _jax_student_step(jcfg, variables, t_vars, batch, mesh)
    got = _mesh_result(worlds, mesh)["scenarios"][name]
    (m,) = got["metrics"]
    for k in ("task_loss", "accuracy"):
        assert m[k] == pytest.approx(float(jm[k]), rel=2e-3, abs=1e-5), k
    want = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": new.params, "batch_stats": new.batch_stats}),
        _port_cfg())
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "pe.pe")):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def _mfm_batch(cfg, data):
    src = SyntheticMultiModalSource(cfg, seed=cfg.train.seed)
    tpb = cfg.train.tasks_per_batch
    if data == 1:
        return src.sample_batch(np.random.default_rng((cfg.train.seed, 0)), tpb)
    e = local_episode_count(tpb, data)
    return concat_batches([src.sample_batch(host_rng(cfg.train.seed, d, 0), e)
                           for d in range(data)])


@pytest.mark.parametrize("mesh", MESHES)
def test_mfm_step_equals_one_process(worlds, jax_trees, mesh):
    """One MFM step at (data, model) (the three-stream encoder's 3 heads
    cut across a head at M = 2 and 4; the two-stream's 2 heads local at
    M = 2) equals the one-process step on the concatenated batch."""
    cfg = _mfm_cfg(torch_config.preset)
    state = create_mfm_train_state(cfg, "cpu", state_dict=_mfm_weights(jax_trees))
    want = make_mfm_train_step(cfg)(state, to_device(_mfm_batch(cfg, mesh[0]),
                                                     "cpu"))
    got = _mesh_result(worlds, mesh)["mfm"]
    assert got["episodes_seen"] == state.episodes_seen == 4
    (m,) = got["metrics"]
    for k, v in want.items():
        assert m[k] == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert "three_fusion.transformer_encoder.layers.0.self_attn." \
        "in_proj_weight" in got["sharded"]
    assert "three_fusion.f1.weight" in got["sharded"]


@pytest.mark.parametrize("mesh", MESHES)
def test_mfm_step_equals_jax_sharded(worlds, jax_trees, mesh):
    """The same MFM step against the JAX package's on a (data, model) mesh
    (rtol 2e-3, atol 1e-5): loss, accuracy and every parameter."""
    _, variables, _ = jax_trees["mfm"]
    jcfg, cfg = _mfm_cfg(jax_config.preset), _mfm_cfg(torch_config.preset)
    batch = JaxEpisodeBatch(*_mfm_batch(cfg, mesh[0]))
    d, m = mesh
    jmesh = jax_make_mesh(jax_config.MeshConfig(data=d, model=m),
                          jax.devices()[:d * m])
    state = jax_create_mfm_state(jcfg, jax.random.key(0), batch)
    state = state.replace(params=shard_variables(variables["params"], jmesh),
                          opt_state=shard_variables(
                              state.tx.init(variables["params"]), jmesh))
    with jax.set_mesh(jmesh):
        new, jm = jax.jit(jax_make_mfm_step(jcfg))(
            state, jax_shard_batch(batch, jmesh))
    got = _mesh_result(worlds, mesh)["mfm"]
    (mm,) = got["metrics"]
    for k in ("task_loss", "accuracy"):
        assert mm[k] == pytest.approx(float(jm[k]), rel=2e-3, abs=1e-5), k
    want = mfm_state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, new.params)}, cfg)
    for k, w in want.items():
        if k.endswith("pe.pe"):
            continue
        np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_eval_equals_one_process(worlds, mesh):
    """The eval of the trained student, its model cut over the model group
    and the chunks over the replicas, gives a one-process eval's summary
    and per-task records (n_tasks 20; rounded to 16 over two replicas)."""
    res = _mesh_result(worlds, mesh)
    cfg = _scenario_cfg("span", _port_cfg)
    student = create_train_state(cfg, "cpu", with_teacher=False).model
    student.load_state_dict(res["scenarios"]["span"]["state_dict"])
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=cfg.data.synthetic_noise)
    n = 20 if mesh[0] == 1 else 16
    records = []
    want = run_eval(cfg, student.eval(), MetaSource(src), n_tasks=n,
                    batch_size=8, seed=0, task_log=records.append)
    got = res["eval"]
    assert got["n_tasks"] == want["n_tasks"] == n
    for k in ("accuracy", "confidence"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k
    assert [r["task"] for r in res["eval_records"]] == list(range(n))
    for a, b in zip(res["eval_records"], records):
        assert a["real_preds"] == b["real_preds"]
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)


@pytest.mark.parametrize("world", list(WORLDS))
def test_ranks_agree(worlds, world):
    """Every rank gathers the same student, and the replicated parameters
    are the same on every rank of every model group."""
    checks = worlds[world]["checks"]
    assert all(c == checks[0] for c in checks), checks


@pytest.mark.parametrize("cli", ["train", "teacher"])
@pytest.mark.parametrize("world", list(WORLDS))
def test_cli_checkpoint_loads_and_resumes(worlds, world, cli):
    """``cli.train`` and ``cli.train_teacher`` at ``--mesh_model`` M write
    one checkpoint from rank 0, in the one-process layout: it loads
    strictly into the unsharded model in one process, and a resume under
    the same mesh continues from it to the next checkpoint."""
    ck = worlds[world]["tmp"] / "cli" / cli
    names = sorted(os.listdir(ck))
    assert [n for n in names if n.endswith(".pt")] == [
        "checkpoint_4.pt", "checkpoint_8.pt"]
    cfg = torch_config.Config.from_dict(json.loads((ck / "config.json").read_text()))
    assert (cfg.mesh.data, cfg.mesh.model) == CLI_MESH[world]
    for n, step in (("checkpoint_4.pt", 2), ("checkpoint_8.pt", 4)):
        sd = torch.load(ck / n, weights_only=True)
        assert sd["step"] == step
        if cli == "train":
            state = create_train_state(cfg, "cpu")
            state.teacher.load_state_dict(sd["teacher_state_dict"], strict=True)
        else:
            state = create_mfm_train_state(cfg, "cpu")
        state.model.load_state_dict(sd["model_state_dict"], strict=True)
        state.optimizer.load_state_dict(sd["optimizer"])


@pytest.mark.parametrize("world", list(WORLDS))
def test_cli_test_equals_one_process(worlds, world):
    """``cli.test`` of the TP run's checkpoint at the same mesh gives the
    one-process eval of that checkpoint."""
    from litemkd_torch.cli.test import main as test_cli
    ck = worlds[world]["tmp"] / "cli" / "train" / "checkpoint_4.pt"
    want = test_cli(["-m", str(ck), "--device", "cpu", "--num_test_tasks", "8"])
    got = worlds[world]["cli_test"]
    for k in ("accuracy", "confidence", "n_tasks"):
        assert got[k] == pytest.approx(want[k], abs=1e-4), k


@pytest.mark.parametrize("world", list(WORLDS))
def test_mesh_not_laying_out_world_raises(worlds, world):
    """A mesh whose model axis does not divide the world (model 3 at world
    2 and 4) raises JAX's ``make_mesh`` error from ``setup_data_parallel``."""
    with pytest.raises(ValueError) as e:
        jax_make_mesh(jax_config.MeshConfig(-1, 3), jax.devices()[:world])
    assert worlds[world]["mesh_error"] == str(e.value)

"""The ported training slice against the JAX package: every loss of the
registry, the LR schedule and optimizers, one train step (gradients,
metrics, running statistics) with and without micro-batches and with the
BN-moment path on and off, parameters after three steps, two steps of
``run_training`` in both packages, checkpoints that the JAX package loads,
the teacher converter, the training CLI's config and a CLI run on the CPU
with no JAX loaded. Tiny preset, fp32, dropout 0, numpy-seeded inputs."""
import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.distill import losses as jlosses
from litemkd_tpu.models import BatchedStudent as JaxBatchedStudent
from litemkd_tpu.ops import pallas_bn as jbn
from litemkd_tpu.tools.torch_export import export_teacher_checkpoint
from litemkd_tpu.tools.torch_import import load_student_checkpoint
from litemkd_tpu.train import run_training as jax_run_training
from litemkd_tpu.train.schedule import multistep_lr
from litemkd_tpu.train.steps import (TrainState as JaxTrainState,
                                     create_train_state as jax_create_state,
                                     make_train_step as jax_make_train_step)
from litemkd_tpu.utils.logging import MetricsLogger as JaxLogger
import litemkd_torch.config as torch_config
from litemkd_torch.cli import train as torch_train_cli
from litemkd_torch.cli.test import load_student
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.distill import losses as tlosses
from litemkd_torch.models import BatchedTeacher
from litemkd_torch.tools.weights import (student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from litemkd_torch.train import (create_train_state, make_optimizer,
                                 make_train_step, run_training, to_device)
from litemkd_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

_SINGLE = {"KD", "ce", "TRXLoss", "CELoss", "wsl", "Dist_KD"}
_TEACHER_ARRAY = {"fc_2", "fc_2_wsl", "strm_KD"}


def _loss_inputs(rng, q=6, way=3):
    def logits(*shape):
        return rng.normal(size=shape).astype(np.float32) * 3

    branches = {k: logits(q, way) for k in
                ("kl", "ce", "fc_1", "fc_2", "pat", "fr", "fr1", "fr2",
                 "query", "logits")}
    branches.update(sup=logits(way, way - 1), sup_ce=logits(way, way - 1),
                    sup_kl=logits(way, way - 1), support_set=logits(q, way, way),
                    feature=logits(4, 8))
    labels = rng.integers(0, way, size=q).astype(np.int32)
    return branches, labels


# the JAX package's registry as it ships (other tests register more names
# into it at run time, so it is not read while tests are collected)
LOSS_NAMES = [
    "CELoss", "Dist_KD", "KD", "KL_feature", "TRXLoss", "ce", "e_dist_1fc_sup",
    "fc_1_sup", "fc_2", "fc_2_sup", "fc_2_sup_2", "fc_2_sup_dist",
    "fc_2_sup_dist_cece", "fc_2_sup_dist_wsl", "fc_2_sup_distdistcece",
    "fc_2_sup_disver", "fc_2_sup_kl", "fc_2_sup_klklcece", "fc_2_wsl",
    "fc_sup", "strm", "strm_1fc_sup", "strm_KD", "strm_expert",
    "strm_fc_2_sup_dist", "support_sim", "wsl"]


@pytest.mark.parametrize("name", LOSS_NAMES)
def test_loss_registry_matches_jax(name):
    assert tlosses.available() == LOSS_NAMES
    assert name in jlosses.available()
    rng = np.random.default_rng(len(name))
    student, labels = _loss_inputs(rng)
    teacher, _ = _loss_inputs(rng)
    if name in _SINGLE:
        student, teacher = student["kl"], teacher["kl"]
    elif name in _TEACHER_ARRAY:
        teacher = teacher["kl"]
    dcfg = jax_config.DistillConfig(temperature=3.0, sup_weight=0.4)
    tcfg = torch_config.DistillConfig(temperature=3.0, sup_weight=0.4)

    def to_torch(x):
        return ({k: torch.from_numpy(v) for k, v in x.items()}
                if isinstance(x, dict) else torch.from_numpy(x))

    want = jlosses.get_distiller(name)(student, teacher, labels, dcfg, 4)
    got = tlosses.get_distiller(name)(to_torch(student), to_torch(teacher),
                                      torch.from_numpy(labels).long(), tcfg, 4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_teacher_regularizers_match_jax():
    x = np.random.default_rng(0).normal(size=(3, 2, 4, 5)).astype(np.float32)
    for fn in ("inter_class_cosine_ratio", "inter_class_cosine"):
        want = float(getattr(jlosses, fn)(jnp.asarray(x)))
        got = float(getattr(tlosses, fn)(torch.from_numpy(x)))
        assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# Schedule and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("milestones,eps", [
    ((2,), 2),               # the tiny preset: decay from update 1
    ((20_000, 40_000), 16),  # the flagship
    ((3, 5, 7), 4),          # all three fold into one decay at update 1
    ((5, 6, 33), 4),         # two fold at update 1, one at update 8
])
def test_lr_sequence_matches_optax(milestones, eps):
    base, gamma = 1e-2, 0.1
    param = torch.nn.Parameter(torch.zeros(1))
    opt, sched = make_optimizer("sgd", [param], base, milestones, gamma, eps)
    want = multistep_lr(base, milestones, gamma, eps)
    last = max(milestones) // eps + 3
    for k in range(last):
        assert opt.param_groups[0]["lr"] == pytest.approx(float(want(k)),
                                                          rel=1e-6), k
        opt.step()
        sched.step()


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizer_updates_match_optax(name):
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(4)]
    tx = jax_make_opt(name)
    params, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = make_optimizer(name, [param], 1e-2, (4,), 0.1, 2)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        param.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-7)


def jax_make_opt(name):
    from litemkd_tpu.train.schedule import make_optimizer as jax_opt
    return jax_opt(name, 1e-2, (4,), 0.1, 2)


# ---------------------------------------------------------------------------
# One train step and three, against make_train_step
# ---------------------------------------------------------------------------

def _cfgs(**model):
    out = []
    for make in (jax_config.preset, torch_config.preset):
        base = make("tiny")
        out.append(base.replace(
            model=dataclasses.replace(base.model, compute_dtype="float32",
                                      trans_dropout=0.0, **model),
            data=dataclasses.replace(base.data, synthetic_noise=2.0)))
    return out


def _with(cfg, **train):
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


def _shift_bn_bias(tree, path=()):
    if isinstance(tree, dict):
        return {k: _shift_bn_bias(v, path + (k,)) for k, v in tree.items()}
    if path[-1] == "bias" and "bn" in path[-2]:
        return tree + np.float32(3.0)
    return tree


@pytest.fixture(scope="module")
def jax_init():
    """A JAX tiny student and teacher (fp32) as numpy trees, and the
    synthetic batches both packages draw.

    Every BatchNorm bias starts at +3 instead of 0. At 0, half the
    pre-activations sit around the ReLU kink, and where a last-bit
    difference between the two frameworks flips a mask it moves a whole
    gradient term (measured: up to 5% of a trunk gradient's maximum in one
    step). At +3 a pre-activation is rarely near the kink, and what is
    compared is the arithmetic of the port."""
    jcfg, cfg = _cfgs()
    src = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=2.0)
    batches = [src.sample_batch(np.random.default_rng(i), 2, train=True)
               for i in range(3)]
    state, t_vars = jax_create_state(jcfg, jax.random.key(0), batches[0],
                                     episodes_per_step=2)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    variables["params"] = _shift_bn_bias(variables["params"])
    return variables, jax.tree_util.tree_map(np.asarray, t_vars), batches


def _port_state(cfg, variables, t_vars):
    teacher = teacher_state_dict_from_reference(
        teacher_state_dict_from_jax(t_vars, cfg), BatchedTeacher(cfg))
    return create_train_state(
        cfg, "cpu", student_state_dict=student_state_dict_from_jax(variables, cfg),
        teacher_state_dict=teacher)


_CAPTURE = optax.GradientTransformation(
    init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_state(variables, tx):
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return JaxTrainState(step=jnp.zeros((), jnp.int32),
                         episodes_seen=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(
                             jnp.asarray, variables["batch_stats"]),
                         opt_state=tx.init(params), rng=jax.random.key(1), tx=tx)


def _stats_sd(cfg, params, stats):
    """Reference-layout running statistics of a JAX tree."""
    sd = student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, {"params": params,
                                            "batch_stats": stats}), cfg)
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("micro,pallas_bn", [(0, False), (1, False), (1, True)])
def test_train_step_matches_jax(monkeypatch, jax_init, micro, pallas_bn):
    """Gradients in the reference layout at rtol 1e-3 and atol 2e-4·max|g|
    (max over all gradients: some are zero up to rounding, as v_linear's
    bias, which the prototype difference cancels). The atol is the JAX
    package's own fp32 error: against a float64 run of the port its trunk
    gradients differ by up to 1.3e-4·max|g|, the port's fp32 ones by
    1.1e-5·max|g|. Metrics and running statistics at rtol 1e-4."""
    monkeypatch.setattr(jbn, "_INTERPRET", True)
    variables, t_vars, batches = jax_init
    jcfg, cfg = (_with(c, micro_batch=micro) for c in _cfgs(pallas_bn=pallas_bn))
    jstate = _jax_state(variables, _CAPTURE)
    new, jm = jax.jit(jax_make_train_step(jcfg))(jstate, t_vars, batches[0])
    state = _port_state(cfg, variables, t_vars)
    metrics = make_train_step(cfg)(state, to_device(batches[0], "cpu"))

    assert set(metrics) == set(jm)
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    want = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": new.opt_state, "batch_stats": new.batch_stats}),
        cfg)
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    assert set(dict(state.model.named_parameters())) - set(grads) == \
        {"classifier.transformers.norm_v.weight",
         "classifier.transformers.norm_v.bias"}
    g_max = max(np.abs(want[name].numpy()).max() for name in grads)
    n = 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=2e-4 * g_max, err_msg=name)
        n += 1
    assert n == 64 + 6       # trunk and fc heads, TCT head
    for name, w in _stats_sd(cfg, new.params, new.batch_stats).items():
        w = w.numpy()
        np.testing.assert_allclose(state.model.get_buffer(name).numpy(), w,
                                   rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def _assert_params_close(got: np.ndarray, want: np.ndarray, name: str):
    """Parameters after a few updates: rtol 1e-3, atol 1e-3·max|p|. Each
    update adds lr × the JAX package's fp32 gradient error (up to
    1.3e-4·max|g|, see test_train_step_matches_jax); measured after three
    updates at lr 1e-3: at most 4.8e-4·max|p| (the stem conv)."""
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max(), err_msg=name)


def test_three_steps_match_jax(jax_init):
    """Parameters after three SGD updates at lr 1e-3. They move (the first
    update changes the stem conv by ~10% of its largest weight); at lr 1e-2
    the tiny student diverges in both packages (task_loss 21.8 → 306 →
    413) and two diverging trajectories part."""
    variables, t_vars, batches = jax_init
    jcfg, cfg = (_with(c, learning_rate=1e-3, micro_batch=1) for c in _cfgs())
    jstate = _jax_state(variables, jax_make_opt_for(jcfg))
    step = jax.jit(jax_make_train_step(jcfg))
    state = _port_state(cfg, variables, t_vars)
    tstep = make_train_step(cfg)
    for b in batches:
        jstate, _ = step(jstate, t_vars, b)
        tstep(state, to_device(b, "cpu"))
    want = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats}),
        cfg)
    moved = 0
    start = student_state_dict_from_jax(variables, cfg)
    for name, p in state.model.named_parameters():
        w = want[name].numpy()
        _assert_params_close(p.detach().numpy(), w, name)
        moved += not np.array_equal(w, start[name].numpy())
    assert moved >= 60


def jax_make_opt_for(jcfg):
    from litemkd_tpu.train.schedule import make_optimizer as jax_opt
    t = jcfg.train
    return jax_opt(t.optimizer, t.learning_rate, t.sch, t.sch_gamma,
                   t.tasks_per_batch)


# ---------------------------------------------------------------------------
# The whole slice: run_training in both packages
# ---------------------------------------------------------------------------

class _JaxCapture(JaxLogger):
    def __init__(self):
        super().__init__(print_freq=0)
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append((int(step), dict(scalars)))


class _Capture(MetricsLogger):
    def __init__(self):
        super().__init__(print_freq=0)
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append((int(step), dict(scalars)))


def test_run_training_matches_jax(jax_init):
    """Two steps of run_training from the same weights (carried across) and
    the same seed: equal per-step task_loss and final weights."""
    variables, t_vars, _ = jax_init
    jcfg, cfg = (_with(c, training_iterations=4, learning_rate=1e-3,
                       micro_batch=1, test_iters=(), print_freq=0)
                 for c in _cfgs())
    jsrc = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=2.0)
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=2.0)
    jlog, tlog = _JaxCapture(), _Capture()
    jstate, _, _ = jax_run_training(jcfg, jsrc, jlog, teacher_vars_init=t_vars,
                                    student_vars_init=variables)
    teacher = teacher_state_dict_from_reference(
        teacher_state_dict_from_jax(t_vars, cfg), BatchedTeacher(cfg))
    state, history = run_training(
        cfg, src, tlog, device="cpu", teacher_state_dict=teacher,
        student_state_dict=student_state_dict_from_jax(variables, cfg))
    assert history == [] and state.step == 2 and state.episodes_seen == 4
    assert [s for s, _ in tlog.records] == [s for s, _ in jlog.records] == [1, 2]
    for (_, got), (_, want) in zip(tlog.records, jlog.records):
        assert got["episodes"] == want["episodes"]
        assert got["task_loss"] == pytest.approx(want["task_loss"], rel=1e-4)
    want = student_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}), cfg)
    for name, v in state.model.state_dict().items():
        if name.endswith(("num_batches_tracked", "norm_v.weight", "norm_v.bias",
                          "pe.pe")):
            continue
        _assert_params_close(v.numpy(), want[name].numpy(), name)


def test_resume_continues_the_run(tmp_path):
    """Two steps in one run equal one step, a checkpoint, and a resumed
    second step (the episode stream continues; optimizer, schedule and
    running statistics come back)."""
    _, cfg = _cfgs()
    cfg = _with(cfg, training_iterations=4, learning_rate=1e-2, sch=(2,),
                test_iters=(), print_freq=0, save_freq=2)
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed)
    straight, _ = run_training(cfg, src, _Capture(), device="cpu")
    d = str(tmp_path / "run")
    first = _with(cfg, training_iterations=2, checkpoint_dir=d)
    run_training(first, src, _Capture(), device="cpu")
    resumed, _ = run_training(_with(cfg, checkpoint_dir=d,
                                    resume_from_checkpoint=True),
                              src, _Capture(), device="cpu")
    assert resumed.step == 2 and resumed.episodes_seen == 4
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)
    assert sorted(p.name for p in Path(d).glob("checkpoint_*.pt")) == \
        ["checkpoint_2.pt", "checkpoint_4.pt"]


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port writes loads in the JAX package's
    load_student_checkpoint and gives the same eval logits."""
    jcfg, cfg = _cfgs()
    d = str(tmp_path / "run")
    cfg = _with(cfg, training_iterations=2, test_iters=(), print_freq=0,
                checkpoint_dir=d)
    run_training(cfg, SyntheticEpisodeSource(cfg, n_classes=16, seed=1),
                 _Capture(), device="cpu")
    path = str(Path(d) / "checkpoint_2.pt")
    jvars = load_student_checkpoint(path, jcfg)
    model = load_student(cfg, path, "cpu")
    batch = JaxSource(jcfg, n_classes=16, seed=2, with_teacher_feats=False
                      ).sample_batch(np.random.default_rng(3), 2, train=False)
    want = JaxBatchedStudent(jcfg).apply(jvars, batch.support_clips,
                                         batch.support_labels,
                                         batch.query_clips, train=False)["logits"]
    tb = to_device(batch, "cpu")
    with torch.inference_mode():
        got = model(tb.support_clips, tb.support_labels, tb.query_clips)["logits"]
    for k in ("kl", "ce", "sup"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_teacher_converter_equals_jax_exporter(jax_init, tmp_path):
    variables, t_vars, _ = jax_init
    jcfg, cfg = _cfgs()
    want = export_teacher_checkpoint(t_vars, jcfg, str(tmp_path / "t.pt"))
    got = teacher_state_dict_from_jax(t_vars, cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    teacher = BatchedTeacher(cfg)
    teacher.load_state_dict(teacher_state_dict_from_reference(got, teacher),
                            strict=True)
    torch.testing.assert_close(teacher.classifier.transformers.k_linear.weight,
                               got["bracnch.transformers.0.k_linear.weight"])


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--preset", "student_fc2sup_dist", "--dataset", "synthetic", "--pallas_bn",
     "--training_iterations", "32", "--test_iters", "32", "--num_test_tasks",
     "8", "-c", "{dir}/run"],
    ["--preset", "tiny", "--opt", "adam", "-lr", "3e-3", "--sch", "4", "8",
     "--micro_batch", "1", "--tasks_per_batch", "4", "--freeze_bn", "--watch",
     "--model_teacher", "test_teacher_TRX_2fcsup_fixed", "--trans_dropout",
     "0.2", "--temperature", "2", "--query_per_class", "3", "--seed", "9",
     "--save_freq", "8", "--print_freq", "1", "--mode", "m", "--debug",
     "-c", "{dir}/x"],
])
def test_train_cli_config_equals_jax(argv, tmp_path):
    argv = [a.format(dir=tmp_path) for a in argv]
    p = argparse.ArgumentParser()
    jax_common.add_common_args(p)
    jax_common.add_train_args(p)
    want = jax_common.build_config(p.parse_args(argv))
    _, got = torch_train_cli.parse(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_cli_runs_on_cpu_without_jax(tmp_path):
    """A fresh interpreter trains the tiny preset through the CLI on the
    CPU, writes a checkpoint the eval CLI reads, and ends with no JAX, flax
    or litemkd_tpu module loaded."""
    ck = tmp_path / "ck"
    code = (
        "import json, sys\n"
        "from litemkd_torch.cli import train, test\n"
        f"state, _ = train.main(['--preset', 'tiny', '--dataset', 'synthetic', "
        f"'--device', 'cpu', '-c', {str(ck)!r}])\n"
        f"s = test.main(['-m', {str(ck / 'checkpoint_4.pt')!r}, "
        "'--device', 'cpu', '--num_test_tasks', '2'])\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'litemkd_tpu'))\n"
        "print(json.dumps({'bad': bad, 'step': state.step, 'n': s['n_tasks']}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {"bad": [], "step": 2, "n": 2}
    assert (ck / "config.json").exists()

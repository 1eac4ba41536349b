"""The expert and pretrain steps against the JAX package: one
``expert_trx`` training step with and without teacher features,
per-block rematerialization, the pretrain state and step with its two SGD
groups and StepLR, and the importers of torchvision, pretrain, expert and
trunk files.

Weights move across with the port's converters, dropout off; the steps are
held in float64 (see ``_expert_cfgs``); tolerances are stated where they
are used.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.train.steps import (TrainState as JaxTrainState,
                                     create_train_state as jax_create_state,
                                     make_train_step as jax_make_train_step)
from litemkd_tpu.train.teacher_steps import (
    create_pretrain_state as jax_create_pretrain_state,
    make_pretrain_step as jax_make_pretrain_step)
import litemkd_torch.config as torch_config
from litemkd_torch.cli import train as torch_train_cli
from litemkd_torch.models import BatchedTeacher
from litemkd_torch.models.backbones import (ActionRecognitionNet, ResNetBackbone,
                                           ViTClassifier)
from litemkd_torch.tools.weights import (classifier_net_state_dict_from_jax,
                                         load_pretrain_init,
                                         load_student_checkpoint,
                                         merge_state_dict,
                                         student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from litemkd_torch.train import (create_pretrain_state, create_train_state,
                                 make_pretrain_model, make_pretrain_step,
                                 make_train_step, to_device)
from test_torch_port_backbones import (_clips, _close, _np_tree, _running_stats,
                                       _shift_bn_bias)

# ---------------------------------------------------------------------------
# Train steps: expert_trx, remat
# ---------------------------------------------------------------------------

class _x64:
    """JAX in float64 inside the block."""

    def __enter__(self):
        self.prev = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.prev)


def _expert_cfgs(**model):
    """The tiny expert student of both packages in float64: resnet18_expert
    (trunk width 512), TRX, TRXLoss, dropout off.

    The training steps are held in float64, where the two packages agree
    to 3e-8·max|g|; what they compare is the port's arithmetic. In fp32
    each framework's rounding differs from the float64 result by more than
    the ported math does: the port's stem gradient by up to 2.7e-3·max|g|
    on 1% of its entries on this batch (a max-pool or ReLU selection
    flipped by the last bit), the JAX package's trunk gradients by up to
    8e-3·max|g| (its BatchNorm takes the variance as E[x²]−E[x]²)."""
    out = []
    for config in (jax_config, torch_config):
        base = config.preset("tiny")
        out.append(base.replace(
            model=dataclasses.replace(base.model, compute_dtype="float64",
                                      trans_dropout=0.0,
                                      backbone="resnet18_expert",
                                      classifier="TRX",
                                      trans_linear_in_dim=512, **model),
            distill=dataclasses.replace(base.distill, name="TRXLoss"),
            data=dataclasses.replace(base.data, synthetic_noise=2.0)))
    return out


# the gradients a JAX step would apply, kept in opt_state
_CAPTURE = optax.GradientTransformation(
    init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    update=lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_expert_step(jcfg, with_teacher):
    """One JAX train step (float64) of the tiny expert student on a seeded
    synthetic batch; returns (initial variables, teacher variables or
    None, batch, gradients and new batch statistics as a variables tree,
    metrics)."""
    batch = JaxSource(jcfg, n_classes=16, seed=0, noise=2.0,
                      with_teacher_feats=with_teacher).sample_batch(
        np.random.default_rng(0), 1, train=True)
    with _x64():
        state, t_vars = jax_create_state(jcfg, jax.random.key(0), batch,
                                         episodes_per_step=2)
        variables = _np_tree({"params": state.params,
                              "batch_stats": state.batch_stats})
        variables["params"] = _shift_bn_bias(variables["params"])
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               episodes_seen=jnp.zeros((), jnp.int32),
                               params=params,
                               batch_stats=variables["batch_stats"],
                               opt_state=_CAPTURE.init(params),
                               rng=jax.random.key(1), tx=_CAPTURE)
        new, metrics = jax.jit(jax_make_train_step(jcfg))(jstate, t_vars, batch)
        new = _np_tree({"params": new.opt_state, "batch_stats": new.batch_stats})
        metrics = {k: float(v) for k, v in metrics.items()}
    return variables, t_vars and _np_tree(t_vars), batch, new, metrics


def _double(tree):
    return {k: v.double() if v.is_floating_point() else v for k, v in tree.items()}


def _port_step(cfg, variables, t_vars, batch):
    """The port's state from the JAX weights, cast to float64 (the
    optimizer keeps its parameters), and one ``make_train_step`` on
    ``batch`` (teacher features cast too). Returns (state, metrics)."""
    teacher = None if t_vars is None else teacher_state_dict_from_reference(
        teacher_state_dict_from_jax(t_vars, cfg), BatchedTeacher(cfg))
    state = create_train_state(
        cfg, "cpu", student_state_dict=_double(student_state_dict_from_jax(
            variables, cfg)),
        teacher_state_dict=teacher, with_teacher=t_vars is not None)
    state.model.double()
    if state.teacher is not None:
        state.teacher.double()
    b = to_device(batch, "cpu")
    if b.support_feats is not None:
        b = b._replace(support_feats=b.support_feats.double(),
                       query_feats=b.query_feats.double())
    return state, make_train_step(cfg)(state, b)


def _check_step(cfg, state, metrics, new, jm):
    """Metrics at rtol 1e-9; gradients in the reference layout and the
    updated running statistics at rtol 1e-6 and atol 1e-6·max (measured:
    3e-8·max|g|)."""
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-9, abs=1e-12), k
    want = student_state_dict_from_jax(new, cfg)
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    assert set(dict(state.model.named_parameters())) - set(grads) == \
        {"classifier.transformers.norm_v.weight",
         "classifier.transformers.norm_v.bias"}
    g_max = max(np.abs(want[n].numpy()).max() for n in grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-6 * g_max, err_msg=n)
    for n, w in _running_stats(want).items():
        _close(state.model.get_buffer(n), w.numpy(), rtol=1e-6, atol=1e-6,
               name=n)


@pytest.fixture(scope="module")
def jax_remat_step():
    """The JAX package's float64 step on a batch without teacher features,
    with ``remat=True`` (``nn.remat`` per block, which changes no value);
    one compile serves the teacher-free step and the remat test."""
    jcfg, cfg = _expert_cfgs(remat=True)
    return cfg, _jax_expert_step(jcfg, False)


@pytest.mark.parametrize("with_teacher", [True, False])
def test_expert_trx_step_matches_jax(with_teacher, jax_remat_step):
    """One training step of the tiny ``expert_trx`` student (depth 18,
    TRX, TRXLoss summing the per-query CE over tasks_per_batch²) against
    the JAX package's: with teacher features (the frozen teacher runs and
    TRXLoss ignores it) and without (no teacher at all)."""
    if with_teacher:
        jcfg, cfg = _expert_cfgs()
        variables, t_vars, batch, new, jm = _jax_expert_step(jcfg, True)
    else:
        cfg, (variables, t_vars, batch, new, jm) = jax_remat_step
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, remat=False))
    assert (t_vars is not None) == with_teacher
    state, metrics = _port_step(cfg, variables, t_vars, batch)
    assert (state.teacher is not None) == with_teacher
    _check_step(cfg, state, metrics, new, jm)


@pytest.mark.parametrize("pallas_bn", [False, True])
def test_remat_matches_plain_and_jax(pallas_bn, jax_remat_step):
    """``--remat`` recomputes each residual block in the backward pass.
    One fp32 training chunk of the port with it gives the loss, gradients
    and BatchNorm running statistics of the port without it, and every
    BatchNorm counts one update, on both BN paths: the recompute updates
    no statistics. Tolerance rtol 1e-5, atol 1e-4·max: the same
    arithmetic, whose fp32 sums the backward may take in another order
    (the port's fp32 gradients differ from float64 ones by up to
    2e-5·max|g| on this batch). On cuDNN's path, in float64, it equals
    the JAX package's step with ``remat=True`` (``_check_step``)."""
    cfg, (variables, t_vars, batch, new, jm) = jax_remat_step
    runs = {}
    for remat in (True, False):
        c = cfg.replace(model=dataclasses.replace(
            cfg.model, remat=remat, pallas_bn=pallas_bn, compute_dtype="float32"))
        state = create_train_state(
            c, "cpu", student_state_dict=student_state_dict_from_jax(variables, c),
            with_teacher=False)
        assert state.model.backbone.resnet.remat == remat
        runs[remat] = (state, make_train_step(c)(state, to_device(batch, "cpu")))
    (rs, rm), (ps, pm) = runs[True], runs[False]
    for k in pm:
        assert float(rm[k]) == pytest.approx(float(pm[k]), rel=1e-5), k
    grads = {n: q.grad for n, q in ps.model.named_parameters() if q.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    for n, p in rs.model.named_parameters():
        if n in grads:
            np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(), rtol=1e-5,
                                       atol=1e-4 * g_max, err_msg=n)
    for (n, b), c in zip(rs.model.named_buffers(), ps.model.buffers()):
        if n.endswith("num_batches_tracked"):
            assert int(b) == int(c) == 1, n
        elif n.endswith(("running_mean", "running_var")):
            _close(b, c.numpy(), rtol=1e-5, atol=1e-5, name=n)
    if not pallas_bn:
        state, metrics = _port_step(cfg, variables, t_vars, batch)
        assert state.model.backbone.resnet.remat
        _check_step(cfg, state, metrics, new, jm)


# ---------------------------------------------------------------------------
# Pretraining
# ---------------------------------------------------------------------------

def test_pretrain_steps_match_jax():
    """Two pretrain steps of a resnet18 ``ActionRecognitionNet`` with the
    two SGD groups (trunk 1e-3, head 1e-2, momentum 0.9, StepLR) from the
    same weights, computed in float64 on both sides (see
    ``_expert_cfgs``): loss and accuracy at rtol 1e-6, then every trunk and
    head weight and running statistic at rtol 1e-6 and atol 1e-6·max. The
    JAX package keeps its parameters in fp32 (flax's ``param_dtype``), so
    after the first update the two differ by fp32 rounding (measured:
    2.3e-8 of the second loss)."""
    jcfg, cfg = (c.replace(model=dataclasses.replace(
        c.model, compute_dtype="float64")) for c in
        (jax_config.preset("tiny"), torch_config.preset("tiny")))
    rng = np.random.default_rng(5)
    batches = [(_clips(10 + i, b=4, size=32), rng.integers(0, 3, 4).astype(np.int32))
               for i in range(2)]
    with _x64():
        jstate, jmodel = jax_create_pretrain_state(
            jcfg, jax.random.key(6), 3, jnp.asarray(batches[0][0]),
            arch="resnet18", lr_groups=(1e-3, 1e-2), steps_per_epoch=1)
        variables = _np_tree({"params": jstate.params,
                              "batch_stats": jstate.batch_stats})
        jstep = jax.jit(jax_make_pretrain_step(jcfg, jmodel))
        jms = []
        for clips, labels in batches:
            jstate, jm = jstep(jstate, jnp.asarray(clips), jnp.asarray(labels))
            jms.append({k: float(v) for k, v in jm.items()})
        want = classifier_net_state_dict_from_jax(_np_tree(
            {"params": jstate.params, "batch_stats": jstate.batch_stats}), 18)
    state = create_pretrain_state(cfg, "cpu", 3, (1e-3, 1e-2), 1, arch="resnet18")
    state.model.load_state_dict(classifier_net_state_dict_from_jax(variables, 18),
                                strict=True)
    state.model.double()
    assert [g["lr"] for g in state.optimizer.param_groups] == [1e-3, 1e-2]
    step = make_pretrain_step(cfg)
    for (clips, labels), jm in zip(batches, jms):
        m = step(state, torch.from_numpy(clips), torch.from_numpy(labels).long())
        for k in ("loss", "accuracy"):
            assert float(m[k]) == pytest.approx(jm[k], rel=1e-6), k
    assert state.step == int(jstate.step) == 2
    assert state.episodes_seen == int(jstate.episodes_seen) == 8
    for n, v in state.model.state_dict().items():
        if not n.endswith("num_batches_tracked"):
            _close(v, want[n].numpy(), rtol=1e-6, atol=1e-6, name=n)


def test_pretrain_step_lr_matches_jax_schedule():
    """The StepLR of both groups, stepped at epoch start: the rate of every
    update of epochs 0-25 (3 updates an epoch) is the JAX package's
    ``base · 0.1 ** ((step // steps_per_epoch + 1) // 10)``."""
    cfg = torch_config.preset("tiny")
    state = create_pretrain_state(cfg, "cpu", 3, (1e-3, 1e-2), 3, arch="resnet18")
    for step in range(26 * 3):
        want = [base * 0.1 ** ((step // 3 + 1) // 10) for base in (1e-3, 1e-2)]
        got = [g["lr"] for g in state.optimizer.param_groups]
        assert got == pytest.approx(want, rel=1e-12), step
        state.optimizer.step()
        state.scheduler.step()
    assert isinstance(make_pretrain_model(cfg, 5, "deit_small"), ViTClassifier)
    with pytest.raises(ValueError, match="unknown pretrain arch"):
        make_pretrain_model(cfg, 5, "vgg16")


# ---------------------------------------------------------------------------
# Importers
# ---------------------------------------------------------------------------

_ATTR = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3",
         "7": "layer4"}


def _torchvision(trunk_sd, prefix="resnet."):
    """The port trunk's entries under ``prefix`` renamed to torchvision's
    attribute names (``conv1``, ``layer1.0.conv1``, ...) with a classifier
    ``fc``: a zoo file as torchvision writes it."""
    out = {}
    for k, v in trunk_sd.items():
        if k.startswith(prefix):
            head, rest = k[len(prefix):].split(".", 1)
            out[f"{_ATTR[head]}.{rest}"] = v.clone()
    out["fc.weight"], out["fc.bias"] = torch.ones(1000, 8), torch.zeros(1000)
    return out


def _trunk_of(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def test_torchvision_resnet50_warm_starts_expert_trx(tmp_path, monkeypatch):
    """A torchvision-layout resnet50 file, written from the port's own
    trunk under torchvision's key names, warm-starts ``cli.train --preset
    expert_trx --init_checkpoint`` at tiny geometry: the trunk is the
    file's, the TRX head keeps its seeded init (no step taken)."""
    trunk = ResNetBackbone(depth=50, num_fc=0)
    with torch.no_grad():
        for p in trunk.parameters():
            p.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(3))
    path = tmp_path / "resnet50-zoo.pth"
    torch.save(_torchvision(trunk.state_dict()), path)
    seen = {}
    monkeypatch.setattr(torch_train_cli, "run_training",
                        lambda cfg, sampler, logger, **k: seen.update(
                            cfg=cfg, state=create_train_state(
                                cfg, "cpu", student_state_dict=k["student_state_dict"],
                                with_teacher=sampler.with_teacher_feats)) or (None, []))
    torch_train_cli.main(["--preset", "expert_trx", "--dataset", "synthetic",
                          "--way", "3", "--shot", "2", "--query_per_class", "2",
                          "--seq_len", "4", "--img_size", "32",
                          "--trans_linear_out_dim", "32", "--init_checkpoint",
                          str(path), "--device", "cpu", "--debug"])
    sd = seen["state"].model.state_dict()
    want = _trunk_of(trunk.state_dict(), "resnet.")
    got = _trunk_of(sd, "backbone.resnet.")
    assert got.keys() == want.keys() and len(want) > 250
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    fresh = create_train_state(seen["cfg"], "cpu").model.state_dict()
    for k, v in sd.items():
        if k.startswith("classifier."):
            torch.testing.assert_close(v, fresh[k], rtol=0, atol=0, msg=k)


def test_importers_route_and_guard(tmp_path):
    """``convnet.`` (pretrain), ``resnet.`` (run.py expert, with its TCT),
    ``trunk.`` and torchvision files load into the pretrain model or the
    student; a resnet34 file into resnet18 raises, and so does a key the
    model lacks."""
    r18 = ActionRecognitionNet(4, depth=18)
    want = _trunk_of(r18.state_dict(), "convnet.")
    files = {}
    for prefix in ("convnet.", "trunk.", "resnet."):
        files[prefix] = tmp_path / f"{prefix[:-1]}.pt"
        sd = {f"{prefix}{k}": v for k, v in want.items()}
        if prefix == "resnet.":       # a run.py expert artifact: trunk + TCT
            tct = torch.nn.Linear(1, 1).state_dict()
            for name in ("k_linear", "v_linear", "norm_k"):
                sd.update({f"transformers.0.{name}.{k}": torch.full(
                    (32, 1024) if (name != "norm_k" and k == "weight") else (32,),
                    1.5) for k in tct})
        torch.save({"model_state_dict": sd}, files[prefix])
    files["zoo"] = tmp_path / "zoo.pth"
    torch.save(_torchvision(r18.state_dict(), "convnet."), files["zoo"])
    for kind, path in files.items():
        got = load_pretrain_init(str(path), "resnet18")
        assert _trunk_of(got, "convnet.").keys() == want.keys(), kind
        model = ActionRecognitionNet(4, depth=18)
        model.load_state_dict(merge_state_dict(model.state_dict(), got), strict=True)
        for k, v in want.items():
            torch.testing.assert_close(model.state_dict()[f"convnet.{k}"], v, msg=k)

    _, cfg = _expert_cfgs()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                trans_linear_out_dim=32))
    expert = load_student_checkpoint(str(files["resnet."]), cfg)
    state = create_train_state(cfg, "cpu", student_state_dict=expert,
                               with_teacher=False)
    assert state.model.classifier.transformers.k_linear.weight[0, 0].item() == 1.5
    assert _trunk_of(state.model.state_dict(), "backbone.resnet.").keys() == \
        want.keys()

    r34 = tmp_path / "r34.pth"
    torch.save(_torchvision(ResNetBackbone(depth=34, num_fc=0).state_dict()), r34)
    with pytest.raises(ValueError, match="resnet34 weights but"):
        load_pretrain_init(str(r34), "resnet18")
    with pytest.raises(ValueError, match="resnet34 weights but"):
        load_student_checkpoint(str(r34), cfg)
    with pytest.raises(KeyError, match="does not exist"):
        merge_state_dict(state.model.state_dict(),
                         {"backbone.resnet.9.weight": torch.zeros(1)})

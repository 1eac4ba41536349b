"""The Baseline expert and DeiT pretraining against the JAX package: every
e_dist/cos head, one ``expert_baseline`` training step on both BN paths,
the ViT forward, one deit pretrain step with its two SGD groups,
``cli.pretrain --arch deit_small``, and DeiT files read across packages.

Weights move across with the port's converters, dropout off. Forwards run
in fp32 and training steps in float64 on both sides; tolerances are stated
where they are used.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.cli import pretrain as jax_pretrain_cli
from litemkd_tpu.models import student as jstudent
from litemkd_tpu.models.backbones.classifier_net import ViTClassifier as JaxViT
from litemkd_tpu.tools.torch_import import load_pretrain_init as jax_pretrain_init
from litemkd_tpu.train.steps import make_train_step as jax_make_train_step
from litemkd_tpu.train.teacher_steps import (
    create_pretrain_state as jax_create_pretrain_state,
    make_pretrain_step as jax_make_pretrain_step)
from litemkd_tpu.utils.logging import MetricsLogger as JaxLogger
from litemkd_tpu.utils.tree import deep_merge_variables
import litemkd_torch.config as torch_config
from litemkd_torch.cli import common as torch_common
from litemkd_torch.cli import pretrain as torch_pretrain_cli
from litemkd_torch.models import student as tstudent
from litemkd_torch.models.backbones import ViTClassifier
from litemkd_torch.tools.weights import (classifier_net_state_dict_from_jax,
                                         load_pretrain_init, merge_state_dict,
                                         student_state_dict_from_jax)
from litemkd_torch.train import (create_pretrain_state, create_train_state,
                                 make_pretrain_model, make_pretrain_step,
                                 make_train_step, to_device)
from litemkd_torch.utils.logging import MetricsLogger
from test_torch_port_backbones import _clips, _close, _np_tree, _shift_bn_bias
from test_torch_port_expert import _CAPTURE, _double, _x64, JaxSource, JaxTrainState
from test_torch_port_pretrain import IMG, N_CLASSES, T, tree  # noqa: F401

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its tensors are tiny, and
    the suite runs several worker processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The e_dist/cos heads
# ---------------------------------------------------------------------------

_TWO_STREAM = {"e_dist_fc2", "e_dist_fc2_sup"}


@pytest.mark.parametrize("name", ["cos", "e_dist", "e_dist_fc2",
                                  "e_dist_fc2_sup", "e_dist_fc2_sup_fixed",
                                  "e_dist_1fc_sup", "true_cosine"])
def test_edist_head_matches_jax(name):
    """Each parameter-free metric head over two episodes against the JAX
    package's vmapped head (``true_cosine``: ``CosDistance`` with the true
    cosine), in float64 at rtol 1e-9 and atol 1e-6. One query equals a
    support row, so that its squared distance, ‖a‖² + ‖b‖² − 2ab, is
    rounding noise of ~1e-14 that the clamp lifts to 1e-12: its root is
    at most 1e-6 in either package (in fp32 the noise's root is ~1e-3,
    different in each)."""
    cfg = torch_config.preset("tiny")
    way, shot, e = cfg.episode.way, cfg.episode.shot, 2
    rng = np.random.default_rng(3)

    def feats(n):
        x = rng.normal(size=(e, n, 4, 64))
        return {"f1": x, "f2": rng.normal(size=x.shape)} \
            if name in _TWO_STREAM else x

    ctx, tgt = feats(way * shot), feats(5)
    same = (lambda d: d["f1"]) if name in _TWO_STREAM else (lambda d: d)
    same(tgt)[0, 2] = same(ctx)[0, 1]
    labels = np.stack([rng.permutation(np.repeat(np.arange(way), shot))
                       for _ in range(e)]).astype(np.int32)
    with _x64():
        if name == "true_cosine":
            from litemkd_tpu.models.classifiers.edist import CosDistance as JaxCos
            from litemkd_torch.models.classifiers import CosDistance
            jm = jax.vmap(lambda c, l, t: JaxCos(way, shot, 4, true_cosine=True)
                          .apply({}, c, l, t, False))
            want = jm(ctx, labels, tgt)
            tm = CosDistance(way, shot, 4, true_cosine=True)
        else:
            jm = jstudent.make_vmapped_classifier(
                name, jax_config.preset("tiny"), module_name=None)
            want = jm.apply({}, ctx, labels, tgt, False)
            tm = tstudent.make_classifier(name, cfg)
        want = _np_tree(want)
    assert not list(tm.parameters())

    def t(x):
        return ({k: torch.from_numpy(v) for k, v in x.items()}
                if isinstance(x, dict) else torch.from_numpy(x))

    got = tm(t(ctx), torch.from_numpy(labels).long(), t(tgt))
    want = want if isinstance(want, dict) else {"out": want}
    got = got if isinstance(got, dict) else {"out": got}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float64
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-9,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# One expert_baseline training step
# ---------------------------------------------------------------------------

def _baseline_cfgs():
    """The tiny ``expert_baseline`` student of both packages in float64:
    ``resnet18_gap`` (the depth-18 form of its ``resnet50_gap``), ``e_dist``,
    ``CELoss``, SGD at the preset's 3e-4."""
    out = []
    for config in (jax_config, torch_config):
        base = config.preset("tiny")
        expert = config.preset("expert_baseline")
        out.append(base.replace(
            model=dataclasses.replace(base.model, compute_dtype="float64",
                                      backbone="resnet18_gap",
                                      classifier=expert.model.classifier),
            distill=expert.distill,
            train=dataclasses.replace(base.train,
                                      learning_rate=expert.train.learning_rate)))
    return out


@pytest.fixture(scope="module")
def jax_baseline_step():
    """One JAX step (float64) on a seeded synthetic batch of 2 episodes:
    (cfg, variables, batch, gradients as a variables tree with the new
    batch statistics, metrics)."""
    jcfg, cfg = _baseline_cfgs()
    batch = JaxSource(jcfg, n_classes=16, seed=0, noise=2.0,
                      with_teacher_feats=False).sample_batch(
        np.random.default_rng(0), 2, train=True)
    with _x64():
        variables = _np_tree(jax.jit(partial(
            jstudent.BatchedStudent(jcfg).init, train=False))(
            jax.random.key(0), batch.support_clips, batch.support_labels,
            batch.query_clips))
        variables["params"] = _shift_bn_bias(variables["params"])
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               episodes_seen=jnp.zeros((), jnp.int32),
                               params=params,
                               batch_stats=variables["batch_stats"],
                               opt_state=_CAPTURE.init(params),
                               rng=jax.random.key(1), tx=_CAPTURE)
        new, metrics = jax.jit(jax_make_train_step(jcfg))(jstate, None, batch)
        grads = _np_tree({"params": new.opt_state,
                          "batch_stats": new.batch_stats})
    return cfg, variables, batch, grads, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("pallas_bn", [False, True])
def test_expert_baseline_step_matches_jax(pallas_bn, jax_baseline_step):
    """One training step of the tiny ``expert_baseline`` student (GAP
    trunk, ``e_dist``, ``CELoss``; no head parameters) against the JAX
    package's float64 step, on cuDNN's BatchNorm path and on the BN-kernel
    path (whose plain sums run on the CPU).

    cuDNN's path: metrics at rel 1e-9; gradients at rtol 1e-6 and atol
    1e-6·max|g| (the converter carries them as fp32); the weights after the
    port's SGD against w − lr·g of JAX's gradients at rtol 1e-9 and the
    gradients' atol times lr; running statistics at rtol 1e-6 and atol
    1e-6·max (the JAX package keeps them in fp32). The BN-kernel path sums
    in fp32 whatever the activations' dtype, as its CUDA kernels do, so it
    is held at the fp32 tolerances of
    ``tests/test_torch_port_train.py::test_train_step_matches_jax``:
    metrics at rel 1e-4, gradients at rtol 1e-3 and atol 2e-4·max|g|, the
    weights at the gradients' atol times lr, statistics at rtol 1e-4
    (measured: 1.2e-5 on the loss, 6.7e-5·max|g|, 6e-6 on a running
    variance)."""
    cfg, variables, batch, grads, jm = jax_baseline_step
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, pallas_bn=pallas_bn))
    rel, g_rtol, g_atol, s_tol = (1e-4, 1e-3, 2e-4, 1e-4) if pallas_bn else \
        (1e-9, 1e-6, 1e-6, 1e-6)
    state = create_train_state(cfg, "cpu", student_state_dict=_double(
        student_state_dict_from_jax(variables, cfg)), with_teacher=False)
    state.model.double()
    assert not list(state.model.classifier.parameters())
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    metrics = make_train_step(cfg)(state, to_device(batch, "cpu"))
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(v, rel=rel, abs=1e-12), k
    want = student_state_dict_from_jax(grads, cfg)
    named = dict(state.model.named_parameters())
    assert all(p.grad is not None for p in named.values())
    g_max = max(float(want[n].abs().max()) for n in named)
    lr = cfg.train.learning_rate
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=g_rtol, atol=g_atol * g_max, err_msg=n)
        np.testing.assert_allclose(
            p.detach().numpy(), (before[n] - lr * want[n].double()).numpy(),
            rtol=1e-9, atol=lr * g_atol * g_max, err_msg=f"updated {n}")
    for n, w in want.items():
        if n.endswith(("running_mean", "running_var")):
            _close(state.model.get_buffer(n), w.numpy(), rtol=s_tol,
                   atol=s_tol, name=n)


# ---------------------------------------------------------------------------
# The ViT: forward, pretrain step, files
# ---------------------------------------------------------------------------

_TINY_VIT = dict(img_size=32, patch=16, dim=48, depth=2, heads=6)


def _tiny_vits(seed=0):
    """A tiny JAX ViT (its variables) and the port's with its weights."""
    jm = JaxViT(num_classes=5, compute_dtype=jnp.float32, **_TINY_VIT)
    variables = _np_tree(jm.init(jax.random.key(seed),
                                 np.zeros((1, 32, 32, 3), np.uint8), train=False))
    tm = ViTClassifier(5, compute_dtype=torch.float32, **_TINY_VIT)
    tm.load_state_dict(classifier_net_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm.eval()


def test_vit_forward_matches_jax():
    """The ViT classifier (2 blocks of width 48, 6 heads, 32 px: 4 patches
    and the two tokens) against the JAX package's on the same weights: a
    batch of uint8 images and a (B, T) clip whose logits are averaged over
    T; fp32 at rtol 1e-5 and atol 1e-5·max. ``img_size`` is fixed at
    construction: another size raises in both."""
    jm, variables, tm = _tiny_vits()
    assert set(tm.state_dict()) >= {"convnet.blocks.1.attn.qkv.weight",
                                    "convnet.patch_embed.proj.weight",
                                    "convnet.dist_token", "fc.weight"}
    for shape in ((3, 32, 32, 3), (2, 3, 32, 32, 3)):
        x = np.random.default_rng(len(shape)).integers(0, 256, shape, np.uint8)
        want = jm.apply(variables, x, train=False)
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert got.shape == (shape[0], 5)
        _close(got, want, rtol=1e-5, atol=1e-5, name=str(shape))
    bad = np.zeros((1, 48, 48, 3), np.uint8)
    with pytest.raises(ValueError, match="img_size"):
        jm.apply(variables, bad, train=False)
    with pytest.raises(ValueError, match="img_size"):
        tm(torch.from_numpy(bad))


def _vit_cfgs(dtype):
    out = []
    for config in (jax_config, torch_config):
        base = config.preset("tiny")
        out.append(base.replace(model=dataclasses.replace(
            base.model, compute_dtype=dtype)))
    return out


def test_deit_pretrain_step_matches_jax():
    """One deit_small pretrain step (12 blocks of width 384 at 32 px, a
    batch of 4 clips of 4 frames) in float64 against the JAX package's:
    loss and accuracy at rel 1e-7; the step's change of every weight in
    both SGD groups (the head ``fc`` at lr_2 0.1, everything else at lr_1
    0.01, momentum 0.9) at rtol 1e-6 and atol 5e-5·max|Δ| of its group.
    Not tighter: flax's LayerNorm reduces in fp32 even on float64 input,
    which moves the normed distillation token by 9e-8, the loss by 1e-9
    relative and the LayerNorm scales' change by up to 9.0e-6·max|Δ|
    (measured). The ViT has no batch statistics."""
    jcfg, cfg = _vit_cfgs("float64")
    clips = _clips(8, b=4, t=4, size=32)
    labels = np.array([0, 2, 1, 2], np.int32)
    with _x64():
        jstate, jmodel = jax_create_pretrain_state(
            jcfg, jax.random.key(0), 3, jnp.asarray(clips), arch="deit_small",
            lr_groups=(0.01, 0.1), steps_per_epoch=5)
        before = _np_tree(jstate.params)
        new, jm = jax.jit(jax_make_pretrain_step(jcfg, jmodel))(
            jstate, jnp.asarray(clips), jnp.asarray(labels))
        delta = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b,
                                       new.params, before)
        jm = {k: float(v) for k, v in jm.items()}
    assert not new.batch_stats
    state = create_pretrain_state(
        cfg, "cpu", 3, (0.01, 0.1), 5, arch="deit_small",
        init_state_dict=_double(classifier_net_state_dict_from_jax(
            {"params": before})))
    state.model.double()
    assert isinstance(state.model, ViTClassifier)
    assert [len(g["params"]) for g in state.optimizer.param_groups] == \
        [len(list(state.model.convnet.parameters())), 2]
    old = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    m = make_pretrain_step(cfg)(state, torch.from_numpy(clips),
                                torch.from_numpy(labels).long())
    for k in ("loss", "accuracy"):
        assert float(m[k]) == pytest.approx(jm[k], rel=1e-7), k
    want = classifier_net_state_dict_from_jax({"params": delta})
    for group in ("convnet.", "fc."):
        names = [n for n in old if n.startswith(group)]
        d_max = max(float(want[n].abs().max()) for n in names)
        assert d_max > 0
        for n in names:
            got = (state.model.get_parameter(n).detach() - old[n]).numpy()
            np.testing.assert_allclose(got, want[n].numpy(), rtol=1e-6,
                                       atol=5e-5 * d_max, err_msg=n)


def _timm_file(tm, path):
    """The port ViT's trunk as timm's ``deit_small_distilled_patch16_224``
    writes it: no prefix, plus the two classifier heads that the importers
    drop."""
    sd = {k[len("convnet."):]: v for k, v in tm.state_dict().items()
          if k.startswith("convnet.")}
    dim = sd["cls_token"].shape[-1]
    sd.update({"head.weight": torch.ones(1000, dim), "head.bias": torch.zeros(1000),
               "head_dist.weight": torch.ones(1000, dim),
               "head_dist.bias": torch.zeros(1000)})
    torch.save(sd, path)


@pytest.mark.parametrize("layout", ["checkpoint", "timm"])
def test_deit_files_read_across_packages(layout, tmp_path):
    """A DeiT trunk written by the port, as its pretrain checkpoint
    (``model_state_dict`` of ``convnet.`` timm names and ``fc``) or as a
    timm file, read back by the JAX package's ``load_pretrain_init(arch=
    "deit_small")`` and by the port's: both leave out the head, and with
    the port's ``fc`` both give the logits of the port model that wrote
    it (fp32, rtol 1e-5, atol 1e-5·max)."""
    _, _, src = _tiny_vits(seed=1)
    path = str(tmp_path / f"{layout}.pt")
    if layout == "timm":
        _timm_file(src, path)
    else:
        torch.save({"model_state_dict": src.state_dict()}, path)
    jm, template, tm = _tiny_vits(seed=2)
    part = load_pretrain_init(path, "deit_small")
    assert not any(k.startswith("fc.") or "head" in k for k in part)
    tm.load_state_dict(merge_state_dict(tm.state_dict(), part), strict=True)
    with torch.no_grad():
        tm.fc.load_state_dict(src.fc.state_dict())
    jcfg = jax_config.preset("tiny")
    jvars = {"params": deep_merge_variables(
        template["params"], jax_pretrain_init(path, jcfg, "deit_small")["params"])}
    jvars["params"]["fc"] = {"kernel": src.fc.weight.detach().numpy().T.copy(),
                             "bias": src.fc.bias.detach().numpy()}
    x = _clips(9, b=2, t=3, size=32)
    with torch.no_grad():
        want = src.eval()(torch.from_numpy(x))
        got = tm(torch.from_numpy(x))
    _close(got, want.numpy(), rtol=1e-5, atol=1e-5, name="port")
    _close(np.asarray(jm.apply(jvars, x, train=False)), want.numpy(),
           rtol=1e-5, atol=1e-5, name="jax")


def test_deit_pretrain_cli_matches_jax(tree, tmp_path, monkeypatch):
    """``cli.pretrain --arch deit_small`` in both packages on the same JPEG
    tree, from the JAX package's init carried across, in fp32: one epoch of
    2 batches of 8 clips, then the test split. The ViT is cut to 2 blocks
    of width 48 in both packages (the full width is held by
    ``test_deit_pretrain_step_matches_jax``). Epoch loss and accuracy at
    rel 1e-4, the same test accuracy and sample count; the port's
    checkpoint holds the ``convnet.`` timm layout and ``fc``."""
    import litemkd_tpu.train.teacher_steps as jax_teacher_steps
    import litemkd_torch.train.teacher_steps as torch_teacher_steps
    for common, config in ((jax_common, jax_config), (torch_common, torch_config)):
        monkeypatch.setattr(common, "preset", lambda name, c=config: _vit_cfgs(
            "float32")[c is torch_config])
    monkeypatch.setattr(jax_teacher_steps, "make_pretrain_model",
                        lambda cfg, n, arch: JaxViT(
                            num_classes=n, compute_dtype=jnp.float32, **_TINY_VIT))
    monkeypatch.setattr(torch_teacher_steps, "make_pretrain_model",
                        lambda cfg, n, arch: ViTClassifier(
                            n, compute_dtype=torch.float32, **_TINY_VIT))
    logs = {"jax": [], "port": []}
    monkeypatch.setattr(JaxLogger, "log", lambda self, step, s, force_print=False:
                        logs["jax"].append(dict(s)))
    monkeypatch.setattr(MetricsLogger, "log", lambda self, step, s, force_print=False:
                        logs["port"].append(dict(s)))

    def argv(out):
        return ["--preset", "tiny", "--dataset", "hmdb", "--rgb_path",
                str(tree / "rgb"), "--traintestlist", str(tree / "splits"),
                "--arch", "deit_small", "--epochs", "1", "--batch_size", "8",
                "--lr_1", "0.001", "--lr_2", "0.05", "-c", str(out)]

    jstate = jax_pretrain_cli.main(argv(tmp_path / "jax"))
    jvars = _np_tree(JaxViT(num_classes=N_CLASSES, compute_dtype=jnp.float32,
                            **_TINY_VIT).init(
        jax.random.key(jax_config.preset("tiny").train.seed),
        jnp.zeros((1, T, IMG, IMG, 3), jnp.uint8), train=False))
    create = torch_pretrain_cli.create_pretrain_state

    def from_jax_init(*a, **k):
        state = create(*a, **k)
        state.model.load_state_dict(classifier_net_state_dict_from_jax(jvars),
                                    strict=True)
        return state

    monkeypatch.setattr(torch_pretrain_cli, "create_pretrain_state", from_jax_init)
    state = torch_pretrain_cli.main(argv(tmp_path / "port") + ["--device", "cpu"])
    assert len(logs["port"]) == len(logs["jax"]) == 1
    got, want = logs["port"][0], logs["jax"][0]
    for k in ("epoch_loss", "epoch_accuracy"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["test_accuracy"] == want["test_accuracy"]
    assert state.episodes_seen == int(jstate.episodes_seen) == 16
    saved = torch.load(tmp_path / "port" / "checkpoint_16.pt",
                       weights_only=True)["model_state_dict"]
    assert {k.split(".")[0] for k in saved} == {"convnet", "fc"}
    assert {"convnet.blocks.1.attn.qkv.weight", "convnet.pos_embed",
            "convnet.norm.bias"} <= set(saved)
    assert isinstance(make_pretrain_model(torch_config.preset("tiny"), 3,
                                          "deit_small"), ViTClassifier)

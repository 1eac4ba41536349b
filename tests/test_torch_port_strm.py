"""The STRM expert against the JAX package: each enrichment block,
``STRMDistance``, the STRM backbones and the three STRM heads, one
``expert_strm``-shaped training step, and the CNN_STRM importer.

Weights move across from the JAX init, with the patch-attention gate
``gamma`` set to 0.75 first (it starts at 0, where the attention adds
nothing). Forwards run in fp32 and the training step in float64 on both
sides, dropout off; tolerances are stated where they are used.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.models import student as jstudent
from litemkd_tpu.ops import strm as jstrm
from litemkd_tpu.tools.torch_import import (
    load_student_checkpoint as jax_load_student_checkpoint)
from litemkd_tpu.train.steps import make_train_step as jax_make_train_step
from litemkd_tpu.utils import deep_merge_variables
import litemkd_torch.config as torch_config
from litemkd_torch.models import BatchedStudent, init_student_
from litemkd_torch.models import student as tstudent
from litemkd_torch.ops import strm as tstrm
from litemkd_torch.tools.weights import (load_student_checkpoint,
                                         merge_state_dict,
                                         student_state_dict_from_jax,
                                         tct_state_dict_from_jax)
from test_torch_port_backbones import _clips, _close, _np_tree, _shift_bn_bias
from test_torch_port_expert import (_CAPTURE, _double, _x64, JaxSource,
                                    JaxTrainState)

# exact in fp32: the converters carry weights as fp32
GAMMA = 0.75


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its tensors are tiny, and
    the suite runs several worker processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _with_gamma(tree):
    """Every ``gamma`` leaf (the patch-attention gate) at ``GAMMA``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GAMMA) if k == "gamma" else _with_gamma(v))
                for k, v in tree.items()}
    return tree


def _load_linears(module, params):
    """flax Dense params (kernel, bias) into ``module``'s Linears and
    ``gamma``, by the JAX submodule names; the port's names are the
    reference's (``value_conv``, ``Bot_MLP``, ``Tok_MLP``)."""
    rename = {"value_proj": "value_conv", "bot_mlp": "Bot_MLP",
              "tok_mlp": "Tok_MLP"}
    with torch.no_grad():
        for k, v in params.items():
            if k == "gamma":
                module.gamma.copy_(torch.from_numpy(np.asarray(v)))
            elif "kernel" in v:
                lin = getattr(module, rename.get(k, k))
                lin.weight.copy_(torch.from_numpy(np.asarray(v["kernel"]).T.copy()))
                lin.bias.copy_(torch.from_numpy(np.asarray(v["bias"])))
            else:
                _load_linears(getattr(module, rename.get(k, k)), v)


def _feats(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Blocks, STRMDistance
# ---------------------------------------------------------------------------

_BLOCKS = {
    "token_mlp": (lambda: jstrm.TokenMLP(6), lambda: tstrm.TokenMLP(6), (2, 5, 6)),
    "bottleneck3": (lambda: jstrm.BottleneckMLP3Res(8),
                    lambda: tstrm.BottleneckMLP3Res(8), (2, 5, 8)),
    "self_attn_bot": (lambda: jstrm.SelfAttnBot(16, 16, dropout=0.0),
                      lambda: tstrm.SelfAttnBot(16, 16, dropout=0.0), (3, 16, 16)),
    "mlp_mix": (lambda: jstrm.MLPMixEnrich(16, 4, dropout=0.0),
                lambda: tstrm.MLPMixEnrich(16, 4, dropout=0.0), (2, 4, 16)),
}


@pytest.mark.parametrize("name", sorted(_BLOCKS))
def test_strm_block_matches_jax(name):
    """Each enrichment block against its JAX module on the same weights
    (``gamma`` 0.75), fp32, at rtol 1e-5 and atol 1e-6·max."""
    make_jax, make_port, shape = _BLOCKS[name]
    x = _feats(1, *shape)
    jm = make_jax()
    kw = {"train": False} if name in ("self_attn_bot", "mlp_mix") else {}
    params = _with_gamma(_np_tree(jm.init(jax.random.key(0), x, **kw)["params"]))
    tm = make_port().eval()
    _load_linears(tm, params)
    want = jm.apply({"params": params}, x, **kw)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want, rtol=1e-5, atol=1e-6, name=name)


def test_strm_distance_matches_jax():
    """``STRMDistance`` over two episodes (the port's episode axis) against
    the JAX module run per episode: the min over each class's shot×tuple
    pool, the mean over query tuples, the ``1e-12`` clamp; fp32 at rtol
    1e-5 and atol 1e-6·max. One support row equals a query, so that one
    distance sits at the clamp."""
    way, shot, seq, d = 3, 2, 4, 16
    support = _feats(2, 2, way * shot, seq, d)
    queries = _feats(3, 2, 4, seq, d)
    queries[0, 1] = support[0, 3]
    labels = np.stack([np.random.default_rng(4 + e).permutation(
        np.repeat(np.arange(way), shot)) for e in range(2)]).astype(np.int32)
    jm = jstrm.STRMDistance(way=way, shot=shot, seq_len=seq, in_dim=d,
                            dropout=0.0)
    params = _np_tree(jm.init(jax.random.key(1), support[0], labels[0],
                              queries[0], train=False)["params"])
    want = np.stack([jm.apply({"params": params}, support[e], labels[e],
                              queries[e], train=False) for e in range(2)])
    tm = tstrm.STRMDistance(way, shot, seq, in_dim=d, dropout=0.0).eval()
    _load_linears(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(support), torch.from_numpy(labels).long(),
                 torch.from_numpy(queries))
    assert got.shape == (2, 4, way)
    _close(got, want, rtol=1e-5, atol=1e-6, name="distance")


# ---------------------------------------------------------------------------
# Backbones, heads
# ---------------------------------------------------------------------------

def _tiny(config, **model):
    base = config.preset("tiny")
    return base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0, **model))


@pytest.mark.parametrize("name", ["strmbackbone", "strm18_student", "cnn_strm"])
def test_strm_backbone_matches_jax(name):
    """The STRM backbones at 32 px against the JAX package's, weights
    through ``student_state_dict_from_jax`` (strict, ``gamma`` 0.75): every
    stream in eval mode, fp32, rtol 1e-4 and atol 1e-5·max. Train mode
    (batch statistics, the running statistics they update, the backward)
    is held in float64 by :func:`test_expert_strm_step_matches_jax`: in
    fp32 the JAX package's BatchNorm variance (E[x²]−E[x]² over 8 frames)
    moves one 'distance' entry of 512 by 1.5e-3 relative, through the
    unscaled patch softmax. JAX runs op by op here, so the depth-18
    entries share their compiles."""
    clips = _clips(5, b=2, t=4, size=32)
    jcfg, cfg = (_tiny(c, backbone=name, classifier="strmclassifiers")
                 for c in (jax_config, torch_config))
    jm = jstudent.make_backbone(name, jcfg, module_name=None)
    variables = _np_tree(jm.init(jax.random.key(6), clips, train=False))
    variables["params"] = _with_gamma(_shift_bn_bias(variables["params"]))
    want = jm.apply(variables, clips, train=False)
    sd = student_state_dict_from_jax(
        {"params": {"backbone": variables["params"]},
         "batch_stats": {"backbone": variables["batch_stats"]}}, cfg)
    tm = tstudent.make_backbone(name, cfg)
    tm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(clips))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], name=k)


def _head_inputs(streams, e=2, seed=7):
    """Feature dicts of two tiny episodes (way 3, shot 2, 2 queries a
    class, seq_len 4, width 64) for the named streams."""
    rng = np.random.default_rng(seed)
    ctx = {k: rng.normal(size=(e, 6, 4, 64)).astype(np.float32) for k in streams}
    tgt = {k: rng.normal(size=(e, 6, 4, 64)).astype(np.float32) for k in streams}
    labels = np.stack([rng.permutation(np.repeat(np.arange(3), 2))
                       for _ in range(e)]).astype(np.int32)
    return ctx, labels, tgt


def _head_state_dict(params, cfg):
    sd = {f"transformers.{k}": v for k, v in tct_state_dict_from_jax(
        params["transformers"], cfg.model.trans_linear_in_dim,
        int(1.5 * cfg.episode.seq_len)).items()}
    clsw = params["distance"]["clsW"]
    sd["distance.clsW.weight"] = torch.from_numpy(np.asarray(clsw["kernel"]).T.copy())
    sd["distance.clsW.bias"] = torch.from_numpy(np.asarray(clsw["bias"]))
    return sd


@pytest.mark.parametrize("name,streams", [
    ("strmclassifiers", ("distance", "trx")),
    ("strm_res18_sup", ("distance", "trx1", "trx2")),
    ("strm_1fc_sup", ("distance", "trx"))])
def test_strm_head_matches_jax(name, streams):
    """Each STRM head over two episodes against the JAX package's vmapped
    head on the same weights: 'pat', the TCT's 'fr' (twice, through one
    shared TCT, for ``strm_res18_sup``) and SupportDK's 'sup'; fp32, rtol
    1e-5 and atol 1e-6·max."""
    jcfg, cfg = (_tiny(c, classifier=name) for c in (jax_config, torch_config))
    ctx, labels, tgt = _head_inputs(streams)
    jm = jstudent.make_vmapped_classifier(name, jcfg, module_name=None)
    params = _np_tree(jm.init(jax.random.key(8), ctx, labels, tgt, False)["params"])
    want = jm.apply({"params": params}, ctx, labels, tgt, False)
    tm = tstudent.make_classifier(name, cfg).eval()
    tm.load_state_dict(_head_state_dict(params, cfg), strict=True)
    t = {k: torch.from_numpy(v) for k, v in ctx.items()}
    q = {k: torch.from_numpy(v) for k, v in tgt.items()}
    with torch.no_grad():
        got = tm(t, torch.from_numpy(labels).long(), q)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], rtol=1e-5, atol=1e-6, name=k)


# ---------------------------------------------------------------------------
# One expert_strm training step
# ---------------------------------------------------------------------------

def _strm_cfgs():
    """The tiny ``expert_strm`` student of both packages in float64:
    ``strmbackbone`` (the depth-18 STRM trunk; ``cnn_strm`` is its resnet50
    form), ``strmclassifiers``, ``strm_expert``, SGD, dropout off."""
    out = []
    for config in (jax_config, torch_config):
        base = config.preset("tiny")
        expert = config.preset("expert_strm")
        out.append(base.replace(
            model=dataclasses.replace(
                base.model, compute_dtype="float64", trans_dropout=0.0,
                backbone="strmbackbone", classifier=expert.model.classifier),
            distill=expert.distill,
            train=dataclasses.replace(base.train, learning_rate=3e-4)))
    return out


def test_expert_strm_step_matches_jax():
    """One ``strm_expert`` training step of the tiny STRM student (2
    episodes, float64) against the JAX package's: the loss terms, every
    gradient (the gate ``gamma`` at 0.75, so the patch attention has one),
    the updated weights (the port's SGD against w − lr·g of JAX's
    gradients) and running statistics. Metrics at rel 1e-9; gradients at
    rtol 1e-6 and atol 1e-6·max|g| (the converter carries them as fp32);
    weights at rtol 1e-9 and the gradients' atol times lr; statistics at
    rtol 1e-6 and atol 1e-6·max."""
    jcfg, cfg = _strm_cfgs()
    batch = JaxSource(jcfg, n_classes=16, seed=0, noise=2.0,
                      with_teacher_feats=False).sample_batch(
        np.random.default_rng(0), 2, train=True)
    with _x64():
        variables = _np_tree(jax.jit(partial(
            jstudent.BatchedStudent(jcfg).init, train=False))(
            jax.random.key(0), batch.support_clips, batch.support_labels,
            batch.query_clips))
        variables["params"] = _with_gamma(_shift_bn_bias(variables["params"]))
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               episodes_seen=jnp.zeros((), jnp.int32),
                               params=params,
                               batch_stats=variables["batch_stats"],
                               opt_state=_CAPTURE.init(params),
                               rng=jax.random.key(1), tx=_CAPTURE)
        new, jm = jax.jit(jax_make_train_step(jcfg))(jstate, None, batch)
        grads = _np_tree({"params": new.opt_state,
                          "batch_stats": new.batch_stats})
        jm = {k: float(v) for k, v in jm.items()}

    from litemkd_torch.train import create_train_state, make_train_step, to_device
    tstate = create_train_state(cfg, "cpu", student_state_dict=_double(
        student_state_dict_from_jax(variables, cfg)), with_teacher=False)
    tstate.model.double()
    before = {n: p.detach().clone() for n, p in tstate.model.named_parameters()}
    metrics = make_train_step(cfg)(tstate, to_device(batch, "cpu"))
    assert set(metrics) == set(jm) >= {"fr_loss", "pat_loss", "task_loss"}
    for k, v in jm.items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-9, abs=1e-12), k

    want = student_state_dict_from_jax(grads, cfg)
    named = dict(tstate.model.named_parameters())
    assert {n for n, p in named.items() if p.grad is None} == \
        {"classifier.transformers.norm_v.weight",
         "classifier.transformers.norm_v.bias"}
    assert float(named["backbone.attn_pat.gamma"].grad.abs()) > 0
    g_max = max(float(want[n].abs().max()) for n in named
                if named[n].grad is not None)
    for n, p in named.items():
        if p.grad is None:
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=1e-6,
                                   atol=1e-6 * g_max, err_msg=n)
        np.testing.assert_allclose(
            p.detach().numpy(),
            (before[n] - 3e-4 * want[n].double()).numpy(), rtol=1e-9,
            atol=3e-4 * 1e-6 * g_max, err_msg=f"updated {n}")
    for n, w in want.items():
        if n.endswith(("running_mean", "running_var")):
            _close(tstate.model.get_buffer(n), w.numpy(), rtol=1e-6, atol=1e-6,
                   name=n)


# ---------------------------------------------------------------------------
# The CNN_STRM importer
# ---------------------------------------------------------------------------

def test_cnn_strm_file_loads_like_jax(tmp_path):
    """A file in the reference's CNN_STRM layout (``resnet.*``,
    ``attn_pat.*`` with ``value_conv``, ``fr_enrich.*``,
    ``transformers.0.*``; no ``lift``, no ``clsW``), written from port
    weights of the depth-18 STRM student at width 512 (where ``lift`` can be
    the identity, as the importers set it), goes through the JAX package's
    ``load_student_checkpoint`` and the port's, each merged over its seeded
    init: the port's lift is the identity and its ``clsW`` stays at the
    init; with the JAX ``clsW`` set to the port's, both give the same
    logits. fp32, rtol 1e-4 and atol 1e-5·max."""
    jcfg, cfg = (_tiny(c, backbone="strmbackbone", classifier="strmclassifiers",
                       trans_linear_in_dim=512) for c in (jax_config, torch_config))
    src = BatchedStudent(cfg)
    init_student_(src, torch.Generator().manual_seed(11))
    with torch.no_grad():
        src.backbone.attn_pat.gamma.fill_(GAMMA)
    ref = {}
    for k, v in src.state_dict().items():
        if k.startswith("backbone.") and not k.startswith(("backbone.lift",
                                                           "backbone.attn_pat.pe",
                                                           "backbone.fr_enrich.pe")):
            ref[k[len("backbone."):]] = v
        elif k.startswith("classifier.transformers.") and not k.endswith("pe.pe"):
            ref["transformers.0." + k[len("classifier.transformers."):]] = v
    path = str(tmp_path / "cnn_strm.pt")
    torch.save(ref, path)

    model = BatchedStudent(cfg)
    init_student_(model, torch.Generator().manual_seed(12))
    init_clsw = model.classifier.distance.clsW.weight.detach().clone()
    model.load_state_dict(merge_state_dict(
        model.state_dict(), load_student_checkpoint(path, cfg)), strict=True)
    torch.testing.assert_close(model.backbone.lift.weight, torch.eye(512))
    torch.testing.assert_close(model.classifier.distance.clsW.weight, init_clsw)

    batch = JaxSource(jcfg, n_classes=16, seed=0, noise=2.0,
                      with_teacher_feats=False).sample_batch(
        np.random.default_rng(1), 1, train=False)
    jm = jstudent.BatchedStudent(jcfg)
    init = _np_tree(jax.jit(partial(jm.init, train=False))(
        jax.random.key(2), batch.support_clips, batch.support_labels,
        batch.query_clips))
    v = deep_merge_variables(init, _np_tree(jax_load_student_checkpoint(path, jcfg)))
    clsw = model.classifier.distance.clsW
    v["params"]["classifier"]["distance"]["clsW"] = {
        "kernel": clsw.weight.detach().numpy().T.copy(),
        "bias": clsw.bias.detach().numpy()}
    want = jax.jit(partial(jm.apply, train=False))(
        v, batch.support_clips, batch.support_labels,
        batch.query_clips)["logits"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batch.support_clips),
                           torch.from_numpy(batch.support_labels).long(),
                           torch.from_numpy(batch.query_clips))["logits"]
    assert got.keys() == want.keys() == {"pat", "fr"}
    for k in want:
        _close(got[k], want[k], name=k)

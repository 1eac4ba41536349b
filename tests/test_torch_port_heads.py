"""The rest of the student zoo's heads and the skeleton expert against the
JAX package: every TRX, OTAM, TRX_multi and CTX head of the registry
forward in fp32; a float64 gradient step of OTAM, CTX and TRX_multi;
OTAM's guard against NaN support features; the skeleton encoder in both
axis modes; the S3D skeleton, teacher-half CTX and TRM artifacts through
both packages' ``load_student_checkpoint``; and ``data/skeleton.py``.

Weights move across from the JAX init through the port's converter
(``classifier_state_dict_from_jax``, ``student_state_dict_from_jax``),
or from port weights written in the reference layout through both
packages' importers. Dropout is off; JAX runs jitted, one compile per
head class. Tolerances are stated where they are used.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.data import skeleton as jskeleton
from litemkd_tpu.models import student as jstudent
from litemkd_tpu.models.backbones.skeleton import SkeletonEncoder as JaxSkeleton
from litemkd_tpu.tools import torch_import as jimport
from litemkd_tpu.tools.torch_export import export_ctx_classifier
import litemkd_torch.config as torch_config
from litemkd_torch.data import skeleton as tskeleton
from litemkd_torch.models import BatchedStudent, BatchedTeacher, init_student_
from litemkd_torch.models import student as tstudent
from litemkd_torch.ops import tct as ttct
from litemkd_torch.tools.weights import (classifier_state_dict_from_jax,
                                         load_student_checkpoint,
                                         merge_state_dict,
                                         student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from test_torch_port_backbones import _close, _np_tree
from test_torch_port_expert import _x64

TEMP_SET = (2, 3)
E, WAY, SHOT, QPC, T, D = 2, 3, 2, 2, 4, 64
TWO_STREAM = {"TRX_2fc", "TRX_2fcsup_2"}
# the heads of this slice; aliases share a class and the JAX results
HEADS = ["TRX_sup", "TRX_sup_fixed", "TRX_2fc", "TRX_1fc_sup", "TRX_2fcsup_2",
         "TRX_2fcsup_2_fixed", "OTAM", "CNN_OTAM", "TRX_multi", "TRM", "CTX",
         "CTX_videoaxis"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its tensors are tiny, and
    the suite runs several worker processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(config, dtype="float32", **model):
    base = config.preset("tiny")
    model = {"compute_dtype": dtype, "trans_dropout": 0.0,
             "temp_set": TEMP_SET, **model}
    return base.replace(model=dataclasses.replace(base.model, **model))


def _inputs(name, seed=7, dtype=np.float32):
    """Two tiny episodes (way 3, shot 2, 2 queries a class, 4 frames,
    width 64): support, labels and queries, as dicts of two streams for
    the two-stream heads."""
    rng = np.random.default_rng(seed)
    streams = ("f1", "f2") if name in TWO_STREAM else (None,)
    ctx = {k: rng.normal(size=(E, WAY * SHOT, T, D)).astype(dtype) for k in streams}
    tgt = {k: rng.normal(size=(E, WAY * QPC, T, D)).astype(dtype) for k in streams}
    labels = np.stack([rng.permutation(np.repeat(np.arange(WAY), SHOT))
                       for _ in range(E)]).astype(np.int32)
    if streams == (None,):
        ctx, tgt = ctx[None], tgt[None]
    return ctx, labels, tgt


def _torch(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(v) for k, v in x.items()}
    return torch.from_numpy(x)


def _outputs(x):
    return x if isinstance(x, dict) else {"logits": x}


_JAX_HEADS = {}


def _jax_head(name):
    """(params, outputs) of the JAX package's vmapped head ``name`` on
    :func:`_inputs`, computed once per head class."""
    cls = jstudent.CLASSIFIERS[name]
    key = (cls, name in TWO_STREAM)
    if key not in _JAX_HEADS:
        jcfg = _cfg(jax_config)
        jm = jstudent.make_vmapped_classifier(name, jcfg, module_name=None)
        ctx, labels, tgt = _inputs(name)
        params = _np_tree(jax.jit(lambda k, c, l, t: jm.init(k, c, l, t, False))(
            jax.random.key(3), ctx, labels, tgt)).get("params", {})
        out = jax.jit(lambda p, c, l, t: jm.apply(p, c, l, t, False))(
            {"params": params}, ctx, labels, tgt)
        _JAX_HEADS[key] = (params, _np_tree(out))
    return _JAX_HEADS[key]


def _port_head(name, params, cfg):
    tm = tstudent.make_classifier(name, cfg)
    tm.load_state_dict(classifier_state_dict_from_jax(params, cfg), strict=True)
    return tm.eval()


@pytest.mark.parametrize("name", HEADS)
def test_head_matches_jax(name):
    """Each head of the registry over two episodes against the JAX
    package's vmapped head, weights from the JAX init through
    ``classifier_state_dict_from_jax`` (strict): every output key
    ('support_set'/'query', 'fc_1'/'fc_2', 'kl'/'sup', 'kl'/'ce'/'sup_kl'/
    'sup_ce', OTAM's softmax, the TCT sets' mean, CTX's frame-level
    logits), fp32 at rtol 1e-5 and atol 1e-6·max (OTAM's soft-min
    recursion: 1e-4 and 1e-5·max)."""
    cfg = _cfg(torch_config)
    params, want = _jax_head(name)
    tm = _port_head(name, params, cfg)
    ctx, labels, tgt = _inputs(name)
    with torch.no_grad():
        got = tm(_torch(ctx), torch.from_numpy(labels).long(), _torch(tgt))
    got, want = _outputs(got), _outputs(want)
    assert got.keys() == want.keys()
    tol = (1e-4, 1e-5) if "OTAM" in name else (1e-5, 1e-6)
    for k in want:
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k], rtol=tol[0], atol=tol[1], name=f"{name} {k}")


def test_trx_sup_prototypes_take_the_plain_route(monkeypatch):
    """TRX_sup's prototypes come from ``tct_attention_plain`` on every
    device (the JAX package computes them outside its Pallas kernel): the
    head never calls the kernel's wrapper, and ``TRX_2fc`` calls it once
    a stream."""
    calls = []
    real = ttct.tct_attention
    monkeypatch.setattr(ttct, "tct_attention",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _cfg(torch_config)
    for name, want in (("TRX_sup", 0), ("TRX_2fc", 2), ("CTX", 1),
                       ("TRX_multi", len(TEMP_SET)), ("OTAM", 0)):
        calls.clear()
        tm = tstudent.make_classifier(name, cfg).eval()
        ctx, labels, tgt = _inputs(name)
        with torch.no_grad():
            tm(_torch(ctx), torch.from_numpy(labels).long(), _torch(tgt))
        assert len(calls) == want, name


# ---------------------------------------------------------------------------
# Float64 gradients: OTAM, CTX, TRX_multi
# ---------------------------------------------------------------------------

def _as_f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("name", ["OTAM", "CTX", "CTX_videoaxis", "TRX_multi"])
def test_head_gradient_step_matches_jax(name):
    """One float64 SGD step of the head's parameters on the summed
    logits weighted by fixed random numbers, against ``jax.grad`` of the
    same loss: the loss at rel 1e-12; the gradients with respect to the
    support and query features at rtol 1e-9 and atol 1e-12·max|g|; those
    with respect to the parameters at rtol 1e-6 and atol 1e-6·max|g| (the
    converter that names them carries them as fp32), and the updated
    weights, w − 0.1·g, at rtol 1e-9 and atol 0.1·1e-6·max|g|. OTAM has no
    parameters; its gradient flows to the features."""
    params, _ = _jax_head(name)
    jcfg, cfg = _cfg(jax_config, "float64"), _cfg(torch_config, "float64")
    ctx, labels, tgt = _inputs(name, seed=9, dtype=np.float64)
    weights = np.random.default_rng(10).normal(size=(E, WAY * QPC, WAY))
    with _x64():
        jm = jstudent.make_vmapped_classifier(name, jcfg, module_name=None)
        p64 = _as_f64(params)

        def loss(p, c, q):
            out = jm.apply({"params": p}, c, labels, q, False)
            return jnp.sum(out * weights)

        want_loss, (gp, gc, gq) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2)))(p64, ctx, tgt)
        gp, gc, gq = _np_tree((gp, gc, gq))
        want_loss = float(want_loss)
    tm = tstudent.make_classifier(name, cfg).double().train()
    tm.load_state_dict(classifier_state_dict_from_jax(p64, cfg), strict=True)
    c, q = (torch.from_numpy(x).requires_grad_(True) for x in (ctx, tgt))
    out = tm(c, torch.from_numpy(labels).long(), q)
    got_loss = (out * torch.from_numpy(weights)).sum()
    got_loss.backward()
    assert got_loss.item() == pytest.approx(want_loss, rel=1e-12)
    for got, want in ((c.grad, gc), (q.grad, gq)):
        _close(got, want, rtol=1e-9, atol=1e-12)
    named = dict(tm.named_parameters())
    if not named:
        assert name == "OTAM"
        return
    want_g = classifier_state_dict_from_jax(gp, cfg)
    g_max = max(float(want_g[k].abs().max()) for k in named
                if named[k].grad is not None)
    before = {k: v.detach().clone() for k, v in named.items()}
    torch.optim.SGD(tm.parameters(), lr=0.1).step()
    n = 0
    for k, p in named.items():
        if p.grad is None:
            assert k.endswith(("norm_v.weight", "norm_v.bias")), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), rtol=1e-6,
                                   atol=1e-6 * g_max, err_msg=k)
        np.testing.assert_allclose(
            p.detach().numpy(), (before[k] - 0.1 * want_g[k].double()).numpy(),
            rtol=1e-9, atol=0.1 * 1e-6 * g_max, err_msg=f"updated {k}")
        n += 1
    assert n == len(named) - sum(k.endswith(("norm_v.weight", "norm_v.bias"))
                                 for k in named)


def test_otam_nan_support_guard():
    """An episode whose support holds a NaN gives zero logits, in both
    packages, and finite gradients to every feature; the other episode is
    untouched. A NaN in the queries stays NaN (the reference guards only
    the support)."""
    params, _ = _jax_head("OTAM")
    ctx, labels, tgt = _inputs("OTAM", seed=11)
    ctx[1, 2, 1, 5] = np.nan
    jm = jstudent.make_vmapped_classifier("OTAM", _cfg(jax_config),
                                          module_name=None)
    want = np.asarray(jm.apply({"params": params}, ctx, labels, tgt, False))
    tm = tstudent.make_classifier("OTAM", _cfg(torch_config))
    c, q = (torch.from_numpy(x).requires_grad_(True) for x in (ctx, tgt))
    got = tm(c, torch.from_numpy(labels).long(), q)
    assert torch.equal(got[1], torch.zeros_like(got[1])) and not want[1].any()
    assert torch.isfinite(got[0]).all() and float(got[0].detach().abs().max()) > 0
    _close(got[0], want[0], rtol=1e-4, atol=1e-5)
    got.sum().backward()
    assert torch.isfinite(c.grad).all() and torch.isfinite(q.grad).all()
    assert float(c.grad[0].abs().max()) > 0
    tgt[0, 1, 0, 3] = np.nan
    with torch.no_grad():
        out = tm(torch.from_numpy(ctx), torch.from_numpy(labels).long(),
                 torch.from_numpy(tgt))
    assert torch.isnan(out[0]).any()


def test_heads_as_teachers_load_like_the_released_layout():
    """``teacher_state_dict_from_jax`` writes a head's TCT sets as the JAX
    package's ``export_teacher_checkpoint`` does (``bracnch.transformers.{i}``),
    and ``teacher_state_dict_from_reference`` puts them back into the
    port's teacher, one set per ``temp_set`` entry for TRX_multi; OTAM has
    nothing to load; a CTX teacher raises (that layout has no
    ``time_trans``)."""
    for name in ("TRX_sup_fixed", "TRX_multi", "OTAM"):
        params, _ = _jax_head(name)
        cfg = _cfg(torch_config, teacher=name)
        released = teacher_state_dict_from_jax({"params": {"classifier": params}},
                                               cfg)
        teacher = BatchedTeacher(cfg)
        teacher.load_state_dict(teacher_state_dict_from_reference(
            released, teacher), strict=True)
        want = classifier_state_dict_from_jax(params, cfg)
        for k, v in want.items():
            assert torch.equal(teacher.state_dict()[f"classifier.{k}"], v), k
        n_sets = {"TRX_sup_fixed": 1, "TRX_multi": len(TEMP_SET), "OTAM": 0}
        assert len(released) == 9 * n_sets[name]     # 9 keys a TCT
    params, _ = _jax_head("CTX")
    with pytest.raises(ValueError, match="TCT sets only"):
        teacher_state_dict_from_jax({"params": {"classifier": params}},
                                    _cfg(torch_config, teacher="CTX"))


def test_ctx_converter_equals_jax_exporter():
    """The port's CTX keys are the compiled head's that the JAX package's
    ``export_ctx_classifier`` writes, value for value."""
    params, _ = _jax_head("CTX")
    jcfg, cfg = _cfg(jax_config), _cfg(torch_config)
    want = export_ctx_classifier(params, jcfg)
    got = classifier_state_dict_from_jax(params, cfg)
    assert {f"classifier.{k}" for k in got} == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[f"classifier.{k}"], err_msg=k)


# ---------------------------------------------------------------------------
# The skeleton encoder and expert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("video_axis", [False, True])
def test_skeleton_encoder_matches_jax(video_axis):
    """``SkeletonEncoder`` (the ``s3d`` and ``s3d_videoaxis`` entries) on
    (3, 4, 17, 3) skeleton clips against the JAX package's, weights through
    ``student_state_dict_from_jax`` (strict), eval mode, fp32 at rtol 1e-5
    and atol 1e-6·max. The video-axis form attends over the 3 clips, so
    its output changes when one clip changes, which the time-axis one's
    others do not."""
    name = "s3d_videoaxis" if video_axis else "s3d"
    jcfg, cfg = (_cfg(c, backbone=name, trans_linear_in_dim=32)
                 for c in (jax_config, torch_config))
    x = np.random.default_rng(12).normal(size=(3, T, 17, 3)).astype(np.float32)
    jm = JaxSkeleton(out_dim=32, video_axis=video_axis)
    params = _np_tree(jax.jit(partial(jm.init, train=False))(
        jax.random.key(13), x))["params"]
    want = np.asarray(jax.jit(partial(jm.apply, train=False))(
        {"params": params}, x))
    sd = student_state_dict_from_jax({"params": {"backbone": params}}, cfg)
    tm = tstudent.make_backbone(name, cfg).eval()
    tm.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        y = x.copy()
        y[2] += 1.0
        moved = tm(torch.from_numpy(y))
    _close(got, want, rtol=1e-5, atol=1e-6, name=name)
    assert bool((moved[0] != got[0]).any()) == video_axis


def _s3d_artifact(model, path):
    """The reference's S3D expert layout of a port student:
    ``encoder.t_embedding``, ``encoder.t_tr`` and ``transformers.{i}``."""
    sd = {}
    for k, v in model.state_dict().items():
        if k.startswith("backbone.") and not k.startswith("backbone.pe."):
            sd["encoder." + k[len("backbone."):]] = v
        elif k.startswith("classifier.transformers.") and not k.endswith("pe.pe"):
            rest = k[len("classifier.transformers."):]
            sd[f"transformers.{rest}" if rest[0].isdigit()
               else f"transformers.0.{rest}"] = v
    torch.save({"model_state_dict": sd}, path)


@pytest.mark.parametrize("name", ["s3d", "s3d_videoaxis"])
def test_skeleton_expert_file_loads_like_jax(name, tmp_path):
    """An S3D skeleton expert file (seeded port weights in the reference
    layout) through both packages' ``load_student_checkpoint``: the port's
    student over two episodes of skeleton clips (one video-axis call per
    episode and side for ``s3d_videoaxis``) gives the JAX package's logits
    on its imported variables, fp32 at rtol 1e-4 and atol 1e-5·max; the
    file's every key reaches the port's model."""
    jcfg, cfg = (_cfg(c, backbone=name, classifier="TRX", temp_set=(2,))
                 for c in (jax_config, torch_config))
    src = BatchedStudent(cfg)
    init_student_(src, torch.Generator().manual_seed(14))
    path = str(tmp_path / "s3d.pt")
    _s3d_artifact(src, path)
    part = load_student_checkpoint(path, cfg)
    model = BatchedStudent(cfg)
    init_student_(model, torch.Generator().manual_seed(15))
    model.load_state_dict(merge_state_dict(model.state_dict(), part), strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    rng = np.random.default_rng(16)
    ctx = rng.normal(size=(E, WAY * SHOT, T, 17, 3)).astype(np.float32)
    tgt = rng.normal(size=(E, WAY * QPC, T, 17, 3)).astype(np.float32)
    labels = np.stack([rng.permutation(np.repeat(np.arange(WAY), SHOT))
                       for _ in range(E)]).astype(np.int32)
    variables = jimport.load_student_checkpoint(path, jcfg)
    want = jax.jit(partial(jstudent.BatchedStudent(jcfg).apply, train=False))(
        variables, ctx, labels, tgt)["logits"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ctx), torch.from_numpy(labels).long(),
                           torch.from_numpy(tgt))["logits"]
    _close(got, want, name=name)
    with pytest.raises(ValueError, match="holds no transformers"):
        torch.save({"encoder.t_embedding.0.weight": torch.zeros(1)},
                   tmp_path / "bad.pt")
        load_student_checkpoint(str(tmp_path / "bad.pt"), cfg)


def test_teacher_ctx_and_trm_files_load_like_jax(tmp_path):
    """Two more reference artifacts through both packages'
    ``load_student_checkpoint``, the port's partial state dict against the
    JAX import carried back through the port's converter: a teacher-half
    CTX file (``resnet.*``, ``time_trans.*`` with its dead ``f1``,
    ``transformers.*``) for a ``CTX_videoaxis`` head, whose logits then
    agree (fp32, rtol 1e-4, atol 1e-5·max); and a TRM file (``backbone.N.*``
    GAP trunk, ``transformers.{0,1}``) for ``TRX_multi``, set i at
    ``classifier.transformers.{i}``."""
    jcfg, cfg = (_cfg(c, backbone="resnet18_expert", classifier="CTX_videoaxis",
                      trans_linear_in_dim=512) for c in (jax_config, torch_config))
    src = BatchedStudent(cfg)
    init_student_(src, torch.Generator().manual_seed(17))
    sd = {}
    for k, v in src.state_dict().items():
        if k.startswith("backbone.resnet."):
            sd["resnet." + k[len("backbone.resnet."):]] = v
        elif k.startswith("classifier.") and not k.endswith("pe.pe"):
            sd[k[len("classifier."):]] = v
    sd["time_trans.f1.weight"] = torch.zeros(512, 512)
    sd["time_trans.f1.bias"] = torch.zeros(512)
    path = str(tmp_path / "ctx.pt")
    torch.save(sd, path)
    part = load_student_checkpoint(path, cfg)
    model = BatchedStudent(cfg)
    model.load_state_dict(merge_state_dict(model.state_dict(), part), strict=True)
    variables = _np_tree(jimport.load_student_checkpoint(path, jcfg))
    back = student_state_dict_from_jax(variables, cfg)
    for k, v in part.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    clips = np.random.default_rng(18).integers(0, 256, (E, WAY * SHOT + WAY * QPC,
                                                        T, 32, 32, 3), np.uint8)
    labels = np.stack([np.random.default_rng(19 + e).permutation(
        np.repeat(np.arange(WAY), SHOT)) for e in range(E)]).astype(np.int32)
    ctx, tgt = clips[:, :WAY * SHOT], clips[:, WAY * SHOT:]
    want = jax.jit(partial(jstudent.BatchedStudent(jcfg).apply, train=False))(
        variables, ctx, labels, tgt)["logits"]
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ctx), torch.from_numpy(labels).long(),
                           torch.from_numpy(tgt))["logits"]
    _close(got, want, name="CTX_videoaxis")

    jcfg, cfg = (_cfg(c, backbone="resnet18_gap", classifier="TRX_multi",
                      trans_linear_in_dim=512) for c in (jax_config, torch_config))
    src = BatchedStudent(cfg)
    init_student_(src, torch.Generator().manual_seed(20))
    sd = {k[len("backbone.resnet."):]: v for k, v in src.state_dict().items()
          if k.startswith("backbone.resnet.")}
    sd = {f"backbone.{k}": v for k, v in sd.items()}
    sd.update({k[len("classifier."):]: v for k, v in src.state_dict().items()
               if k.startswith("classifier.") and not k.endswith("pe.pe")})
    path = str(tmp_path / "trm.pt")
    torch.save(sd, path)
    part = load_student_checkpoint(path, cfg)
    back = student_state_dict_from_jax(_np_tree(
        jimport.load_student_checkpoint(path, jcfg)), cfg)
    assert {k for k in part if not k.endswith("num_batches_tracked")} == \
        {k for k in back if not k.endswith(("num_batches_tracked", "pe.pe",
                                            "norm_v.weight", "norm_v.bias"))}
    for k, v in part.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="temp_set"):
        load_student_checkpoint(path, _cfg(torch_config, backbone="resnet18_gap",
                                           classifier="TRX_multi",
                                           trans_linear_in_dim=512,
                                           temp_set=(2, 3, 4)))


def test_skeleton_preprocessing_equals_jax():
    """``data/skeleton.py``: the port's numpy copy of each step gives the
    JAX package's arrays exactly, on NTU-shaped (N, C, T, V, M) data with
    trailing and leading null frames and a missing body."""
    rng = np.random.default_rng(21)
    data = rng.normal(size=(3, 3, 12, 25, 2)).astype(np.float32)
    data[:, :, 8:] = 0.0
    data[1, :, :, :, 1] = 0.0
    data[2, :, :3, :, 0] = 0.0
    for fn in ("pad_null_frames", "center_spine", "rotate_to_canonical",
               "preprocess_skeleton"):
        want = getattr(jskeleton, fn)(data)
        got = getattr(tskeleton, fn)(data)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=fn)

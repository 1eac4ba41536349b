"""litemkd_torch ops against the JAX package: the TCT attention (plain
version vs the einsum path and the Pallas kernel in interpret mode), the
TemporalCrossTransformer at the flagship width, and SupportDK. The CUDA
kernel's own tests are in test_torch_port_cuda.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from litemkd_tpu.ops import pallas_tct as pt
from litemkd_tpu.ops import tct as jtct
from litemkd_tpu.ops import distances as jdist
from litemkd_torch.ops import tct_attention as ta
from litemkd_torch.ops.distances import support_dk_logits
from litemkd_torch.ops.tct import TemporalCrossTransformer, class_sort
from litemkd_torch.tools.weights import tct_state_dict_from_jax


def _tct_inputs(seed, e, q, u, dk, w, s):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((e, q, u, dk), (e, q, u, dk),
                          (e, w, s, u, dk), (e, w, s, u, dk))]


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("q", [3, 11])
def test_plain_matches_xla_and_pallas(monkeypatch, q):
    monkeypatch.setattr(pt, "_INTERPRET", True)
    arrs = _tct_inputs(q, 2, q, 6, 128, 3, 2)
    got = ta.tct_attention_plain(*_torch(arrs)).numpy()
    want_xla = np.asarray(jax.vmap(pt.tct_attention_xla)(*arrs))
    want_pallas = np.asarray(jax.vmap(pt.tct_attention_pallas)(*arrs))
    assert got.shape == (2, q, 3)
    np.testing.assert_allclose(got, want_xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q,u,dk,w,s", [
    (3, 6, 128, 130, 2),     # past the TPU kernel's 128-lane cap
    (5, 28, 1152, 5, 5),     # flagship eval shape
])
def test_plain_matches_xla_wide(q, u, dk, w, s):
    arrs = _tct_inputs(w + q, 1, q, u, dk, w, s)
    got, proto = ta.tct_attention_plain(*_torch(arrs), return_proto=True)
    want, want_proto = jax.vmap(
        lambda *a: pt.tct_attention_xla(*a, return_proto=True))(*arrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(proto.numpy(), np.asarray(want_proto),
                               rtol=1e-4, atol=1e-4)


def test_wrapper_takes_plain_on_cpu_and_counts_no_launch():
    arrs = _torch(_tct_inputs(0, 2, 3, 6, 32, 3, 2))
    before = ta.tct_attention.launches
    got = ta.tct_attention(*arrs)
    assert ta.tct_attention.launches == before
    torch.testing.assert_close(got, ta.tct_attention_plain(*arrs),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["q_v", "class_v", "class_k_dk", "rank"])
def test_wrapper_rejects_mismatched_shapes(bad):
    qk, qv, ck, cv = _torch(_tct_inputs(0, 2, 3, 6, 32, 3, 2))
    if bad == "q_v":
        qv = qv[:, :2]
    elif bad == "class_v":
        cv = cv[:, :2]
    elif bad == "class_k_dk":
        ck = ck[..., :16]
        cv = cv[..., :16]
    else:
        qk, qv = qk[0], qv[0]
    with pytest.raises(ValueError):
        ta.tct_attention(qk, qv, ck, cv)


def test_class_sort_matches_jax():
    rng = np.random.default_rng(3)
    way, shot = 4, 3
    support = rng.normal(size=(2, way * shot, 5, 7)).astype(np.float32)
    labels = np.stack([rng.permutation(np.repeat(np.arange(way), shot))
                       for _ in range(2)]).astype(np.int32)
    got = class_sort(torch.from_numpy(support), torch.from_numpy(labels),
                     way, shot).numpy()
    for e in range(2):
        want = jtct.class_sort(jnp.asarray(support[e]), jnp.asarray(labels[e]),
                               way, shot)
        np.testing.assert_array_equal(got[e], np.asarray(want))


def test_support_dk_matches_jax():
    rng = np.random.default_rng(4)
    way, shot, t, d = 5, 2, 4, 16
    support = rng.normal(size=(3, way * shot, t, d)).astype(np.float32)
    labels = np.stack([rng.permutation(np.repeat(np.arange(way), shot))
                       for _ in range(3)]).astype(np.int32)
    got = support_dk_logits(torch.from_numpy(support), torch.from_numpy(labels),
                            way, shot, t).numpy()
    want = jax.vmap(lambda s, l: jdist.support_dk_logits(s, l, way, shot, t))(
        support, labels)
    assert got.shape == (3, way, way - 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tct_flagship_width_matches_jax():
    """TemporalCrossTransformer at in_dim 2048, dk 1152 (5-way 5-shot, 8
    frames, 5 queries) on weights carried across from a JAX init."""
    way, shot, t, d, dk, q = 5, 5, 8, 2048, 1152, 5
    rng = np.random.default_rng(5)
    support = rng.normal(size=(way * shot, t, d)).astype(np.float32)
    labels = rng.permutation(np.repeat(np.arange(way), shot)).astype(np.int32)
    queries = rng.normal(size=(q, t, d)).astype(np.float32)
    jm = jtct.TemporalCrossTransformer(way=way, shot=shot, seq_len=t,
                                       in_dim=d, out_dim=dk)
    variables = jm.init(jax.random.key(0), support, labels, queries,
                        train=False)
    want = np.asarray(jm.apply(variables, support, labels, queries,
                               train=False))
    tm = TemporalCrossTransformer(way, shot, t, in_dim=d, out_dim=dk).eval()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tm.load_state_dict(tct_state_dict_from_jax(params, d, int(1.5 * t)),
                       strict=True)
    with torch.inference_mode():
        got = tm(torch.from_numpy(support)[None], torch.from_numpy(labels)[None],
                 torch.from_numpy(queries)[None]).numpy()[0]
    assert got.shape == (q, way)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ---------------------------------------------------------------------------
# TCT gradients: the plain recompute against jax.vjp(tct_attention_xla)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,w", [(3, 3), (11, 3), (25, 3), (3, 130)])
def test_tct_backward_plain_matches_jax_vjp(q, w):
    e, u, dk, s = 2, 6, 32, 2
    arrs = _tct_inputs(q + w, e, q, u, dk, w, s)
    g = np.random.default_rng(q * w).normal(size=(e, q, w)).astype(np.float32)
    _, vjp = jax.vjp(jax.vmap(pt.tct_attention_xla), *arrs)
    want = vjp(jnp.asarray(g))
    got = ta.tct_attention_backward_plain(torch.from_numpy(g), *_torch(arrs))
    for gg, ww in zip(got, want):
        ww = np.asarray(ww)
        np.testing.assert_allclose(gg.numpy(), ww, rtol=1e-4,
                                   atol=1e-5 * np.abs(ww).max())


def test_tct_wrapper_is_differentiable_on_cpu():
    arrs = [a.requires_grad_(True) for a in _torch(_tct_inputs(1, 1, 3, 6, 16, 3, 2))]
    g = torch.randn(1, 3, 3)
    ta.tct_attention(*arrs).backward(g)
    want = ta.tct_attention_backward_plain(g, *(a.detach() for a in arrs))
    for a, w in zip(arrs, want):
        torch.testing.assert_close(a.grad, w, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Training-mode BatchNorm against the JAX package (pallas_bn.py), whose
# kernels run in interpret mode as tests/test_pallas_bn.py runs them
# ---------------------------------------------------------------------------

from litemkd_tpu.ops import pallas_bn as jbn  # noqa: E402
from litemkd_torch.ops import batch_norm as tbn  # noqa: E402


@pytest.mark.parametrize("shape", [(6, 5, 7, 16), (2, 3, 2, 2048)])
def test_batch_norm_train_matches_jax(monkeypatch, shape):
    """y, mean and var at rtol 1e-5; the gradients of x, γ and β at 1e-4.
    R = 210 rows of C = 16, and C = 2048 (resnet50 layer4)."""
    monkeypatch.setattr(jbn, "_INTERPRET", True)
    rng = np.random.default_rng(shape[-1])
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    (y, mean, var), vjp = jax.vjp(
        lambda a, s, b: jbn.batch_norm_train(a, s, b, 1e-5, True), x, scale, bias)
    dx, ds, db = vjp((jnp.asarray(g), jnp.zeros(c), jnp.zeros(c)))
    xt, st, bt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x.reshape(-1, c), scale, bias))
    ty, tmean, tvar = tbn.batch_norm_train(xt, st, bt, 1e-5)
    ty.backward(torch.from_numpy(g.reshape(-1, c)))
    y = np.asarray(y).reshape(-1, c)
    np.testing.assert_allclose(ty.detach().numpy(), y, rtol=1e-5,
                               atol=1e-5 * np.abs(y).max())
    np.testing.assert_allclose(tmean.numpy(), np.asarray(mean), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(var), rtol=1e-5)
    for got, want in ((xt.grad, np.asarray(dx).reshape(-1, c)),
                      (st.grad, ds), (bt.grad, db)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_bn_sums_plain_on_cpu_counts_no_launch():
    x = torch.randn(50, 8)
    dy = torch.randn(50, 8)
    before = (tbn.bn_sums.launches, tbn.bn_bwd_sums.launches)
    s = tbn.bn_sums(x)
    b = tbn.bn_bwd_sums(dy, x, x.mean(0), torch.ones(8))
    assert (tbn.bn_sums.launches, tbn.bn_bwd_sums.launches) == before
    torch.testing.assert_close(s, torch.stack([x.sum(0), (x * x).sum(0)]))
    torch.testing.assert_close(b[0], dy.sum(0))
    with pytest.raises(ValueError):
        tbn.bn_bwd_sums(dy[:, :4], x, x.mean(0), torch.ones(8))


def _flax_bn(use_pallas):
    import flax.linen as nn
    if use_pallas:
        return jbn.PallasBatchNorm(use_running_average=False, momentum=0.9,
                                   epsilon=1e-5, dtype=jnp.float32,
                                   use_pallas=True)
    return nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.float32)


@pytest.mark.parametrize("pallas_bn", [False, True])
def test_batch_norm_module_running_stats_match_jax(monkeypatch, pallas_bn):
    """One training update of the port's BatchNorm against PallasBatchNorm
    and flax nn.BatchNorm from the same non-trivial running statistics: y
    and both running statistics at rtol 1e-5. The running variance takes
    the biased batch variance on both of the port's paths."""
    monkeypatch.setattr(jbn, "_INTERPRET", True)
    rng = np.random.default_rng(7)
    n, h, w, c = 6, 4, 4, 12     # R = 96, as at the tiny preset's layer4
    x = rng.normal(size=(n, h, w, c)).astype(np.float32) * 1.5 + 0.3
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    m = tbn.BatchNorm(c, pallas_bn=pallas_bn).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(params["scale"]))
        m.bias.copy_(torch.from_numpy(params["bias"]))
        m.running_mean.copy_(torch.from_numpy(stats["mean"]))
        m.running_var.copy_(torch.from_numpy(stats["var"]))
    y = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    for use_pallas in (False, True):
        want_y, mut = _flax_bn(use_pallas).apply(
            {"params": params, "batch_stats": stats}, x,
            mutable=["batch_stats"])
        want_y = np.asarray(want_y)
        np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-5,
                                   atol=1e-5 * np.abs(want_y).max())
        np.testing.assert_allclose(m.running_mean.numpy(),
                                   np.asarray(mut["batch_stats"]["mean"]),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(m.running_var.numpy(),
                                   np.asarray(mut["batch_stats"]["var"]),
                                   rtol=1e-5)


def test_batch_norm_freeze_and_layout():
    m = tbn.BatchNorm(8, freeze_bn=True).train()
    with torch.no_grad():
        m.running_mean.uniform_(-1, 1)
    before = m.running_mean.clone()
    x = torch.randn(2, 4, 4, 8).permute(0, 3, 1, 2)
    y = m(x)
    torch.testing.assert_close(y, m.eval()(x))
    assert torch.equal(m.running_mean, before)
    with pytest.raises(ValueError, match="channels-last"):
        tbn.BatchNorm(8, pallas_bn=True).train()(torch.randn(2, 8, 4, 4))

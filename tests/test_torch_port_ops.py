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

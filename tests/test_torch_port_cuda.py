"""The port's CUDA kernel on the card, against its plain version. Every test
here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from litemkd_torch import preset
from litemkd_torch.ops import tct_attention as ta


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TCT kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, device, e, q, u, dk, w, s):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
            for shape in ((e, q, u, dk), (e, q, u, dk),
                          (e, w, s, u, dk), (e, w, s, u, dk))]


@pytest.mark.cuda
@pytest.mark.parametrize("e,q,u,dk,w,s", [
    (8, 5, 28, 1152, 5, 5),     # eval chunk at the flagship width
    (4, 25, 28, 1152, 5, 5),    # training micro-batch
    (2, 3, 28, 100, 130, 1),    # ragged dk, W past 128
    (3, 11, 6, 128, 3, 2),
    (1, 1, 56, 64, 2, 5),       # U=56 (temp set 3): 32-column value slices
    (1, 2, 120, 40, 3, 1),      # U=120: 16-column slices, 4 score tiles a thread
])
def test_kernel_matches_plain(cuda_device, e, q, u, dk, w, s):
    args = _inputs(q + w, cuda_device, e, q, u, dk, w, s)
    before = ta.tct_attention.launches
    got = ta.tct_attention(*args)
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 1
    want = ta.tct_attention_plain(*args)
    assert got.shape == (e, q, w) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _inputs(0, cuda_device, 1, 2, 6, 32, 3, 2)
    with pytest.raises(TypeError):
        ta.tct_attention(*(a.double() for a in args))
    strided = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        ta.tct_attention(strided, *args[1:])
    with pytest.raises(ValueError):
        ta.tct_attention(args[0].cpu(), *args[1:])


@pytest.mark.cuda
def test_student_eval_launches_kernel_twice(cuda_device):
    """A BatchedStudent forward on the card runs the TCT kernel once per
    branch (kl, ce) for the whole episode batch."""
    from litemkd_torch.cli.test import load_student
    cfg = preset("tiny")
    model = load_student(cfg, None, cuda_device)
    ep = cfg.episode
    rng = np.random.default_rng(0)
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = torch.from_numpy(rng.integers(0, 256, (2, ep.way * ep.shot, *shape),
                                        dtype=np.uint8)).to(cuda_device)
    qry = torch.from_numpy(rng.integers(0, 256, (2, ep.way, *shape),
                                        dtype=np.uint8)).to(cuda_device)
    lab = torch.arange(ep.way, device=cuda_device).repeat_interleave(
        ep.shot).repeat(2, 1)
    before = ta.tct_attention.launches
    with torch.inference_mode():
        out = model(sup, lab, qry)["logits"]
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 2
    assert all(torch.isfinite(v).all() for v in out.values())


# ---------------------------------------------------------------------------
# BN-moment kernels (csrc/bn_moments.cu) against their plain versions
# ---------------------------------------------------------------------------

BN_SHAPES = [
    (210, 16),        # ragged tail, narrow C
    (1000, 100),      # ragged C: the one-element load path in bf16
    (4096, 2048),     # wide C: two channel blocks in fp32
    (313600, 256),    # flagship layer3 chunk
    (78400, 512),     # flagship layer4 chunk
]


def _bn_inputs(seed, device, r, c, dtype):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(r, c, generator=g, device=device) * 2 + 0.5).to(dtype)
    dy = torch.randn(r, c, generator=g, device=device).to(dtype)
    xf = x.float()
    mean = xf.mean(0)
    inv = torch.rsqrt(xf.var(0, unbiased=False) + 1e-5)
    return x, dy, mean, inv


def _bn_tol(terms):
    """1e-5 of Σ|term| per channel: fp32 sums of r terms in another order."""
    return 1e-5 * terms.abs().sum(0) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c", BN_SHAPES)
def test_bn_kernels_match_plain(cuda_device, r, c, dtype):
    from litemkd_torch.ops import batch_norm as bn
    x, dy, mean, inv = _bn_inputs(r + c, cuda_device, r, c, dtype)
    before = (bn.bn_sums.launches, bn.bn_bwd_sums.launches)
    got = bn.bn_sums(x)
    got_b = bn.bn_bwd_sums(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (bn.bn_sums.launches, bn.bn_bwd_sums.launches) == \
        (before[0] + 1, before[1] + 1)
    want = bn.bn_sums_plain(x)
    want_b = bn.bn_bwd_sums_plain(dy, x, mean, inv)
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean) * inv
    assert got.shape == (2, c) and got.dtype == torch.float32
    assert ((got[0] - want[0]).abs() <= _bn_tol(xf)).all()
    assert ((got[1] - want[1]).abs() <= _bn_tol(xf * xf)).all()
    assert ((got_b[0] - want_b[0]).abs() <= _bn_tol(dyf)).all()
    assert ((got_b[1] - want_b[1]).abs() <= _bn_tol(dyf * xhat)).all()
    # the same inputs give bitwise the same sums: fixed-order reduction
    assert torch.equal(bn.bn_sums(x), got)
    assert torch.equal(bn.bn_bwd_sums(dy, x, mean, inv), got_b)


@pytest.mark.cuda
def test_bn_kernels_reject_what_they_do_not_take(cuda_device):
    from litemkd_torch.ops import batch_norm as bn
    x, dy, mean, inv = _bn_inputs(0, cuda_device, 64, 32, torch.float32)
    with pytest.raises(TypeError):
        bn.bn_sums(x.double())
    with pytest.raises(ValueError):
        bn.bn_sums(x.t())
    with pytest.raises(TypeError):
        bn.bn_bwd_sums(dy.bfloat16(), x, mean, inv)
    with pytest.raises(ValueError):
        bn.bn_bwd_sums(dy, x.cpu(), mean, inv)
    nchw = torch.randn(2, 8, 4, 4, device=cuda_device)   # not channels-last
    with pytest.raises(ValueError):
        bn.channels_last_rows(nchw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_train_matches_cpu(cuda_device, dtype):
    """The autograd Function on the card (kernels) against the CPU (plain
    sums): y, batch moments and the gradients of x, γ and β."""
    from litemkd_torch.ops.batch_norm import batch_norm_train
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2000, 64)).astype(np.float32)).to(dtype)
    outs = {}
    for dev in ("cpu", cuda_device):
        xs, ws, bs = (t.to(dev).detach().requires_grad_(True)
                      for t in (x, w, b))
        y, mean, var = batch_norm_train(xs, ws, bs, 1e-5)
        y.backward(g.to(dev))
        outs[str(dev)] = [t.detach().float().cpu() for t in
                          (y, mean, var, xs.grad, ws.grad, bs.grad)]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(outs[str(cuda_device)], outs["cpu"]):
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()


# ---------------------------------------------------------------------------
# TCT gradients and the training path on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("e,q,u,dk,w,s", [
    (4, 25, 28, 1152, 5, 5),    # training micro-batch at the flagship width
    (2, 3, 28, 100, 130, 1),
])
def test_tct_function_gradients_match_plain(cuda_device, e, q, u, dk, w, s):
    args = _inputs(e + q, cuda_device, e, q, u, dk, w, s)
    g = torch.randn(e, q, w, device=cuda_device)
    ops = [a.clone().requires_grad_(True) for a in args]
    out = ta.tct_attention(*ops)
    assert out.grad_fn is not None
    out.backward(g)
    ref = [a.clone().requires_grad_(True) for a in args]
    ta.tct_attention_plain(*ref).backward(g)
    for got, want in zip(ops, ref):
        err = (got.grad - want.grad).abs().max().item()
        assert err <= 1e-4 * want.grad.abs().max().item() + 1e-6


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu_and_counts_launches(cuda_device):
    """One tiny fp32 train step with pallas_bn and the teacher: the card
    launches the TCT kernel 3 times (student kl, ce; teacher kl) and each BN
    kernel once per BatchNorm (20), and its gradients, the TCT head's
    included, equal the CPU's."""
    import dataclasses
    from litemkd_torch.cli.common import build_sampler
    from litemkd_torch.ops import batch_norm as bn
    from litemkd_torch.train import create_train_state, make_train_step, to_device
    base = preset("tiny")
    cfg = base.replace(
        model=dataclasses.replace(base.model, compute_dtype="float32",
                                  pallas_bn=True, trans_dropout=0.0))
    batch = build_sampler(cfg).sample_batch(np.random.default_rng(0),
                                            cfg.train.tasks_per_batch)
    cpu = create_train_state(cfg, "cpu")
    # BN biases at +3: no pre-activation sits at a ReLU kink, where a
    # last-bit difference between the card and the CPU flips a mask
    with torch.no_grad():
        for m in cpu.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.fill_(3.0)
    gpu = create_train_state(cfg, cuda_device,
                             student_state_dict=cpu.model.state_dict(),
                             teacher_state_dict=cpu.teacher.state_dict())
    step = make_train_step(cfg)
    m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
    counts = (ta.tct_attention.launches, bn.bn_sums.launches,
              bn.bn_bwd_sums.launches)
    m_gpu = step(gpu, to_device(batch, cuda_device))
    torch.cuda.synchronize()
    assert (ta.tct_attention.launches - counts[0], bn.bn_sums.launches - counts[1],
            bn.bn_bwd_sums.launches - counts[2]) == (3, 20, 20)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6, k
    # 1e-3 of the largest gradient: some gradients are zero up to rounding
    gpu_params = dict(gpu.model.named_parameters())
    grads = {n: p.grad for n, p in cpu.model.named_parameters()
             if p.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, p in gpu_params.items():
        if name not in grads:
            assert p.grad is None, name
            continue
        assert (p.grad.cpu() - grads[name]).abs().max().item() <= 1e-3 * g_max, name
    assert sum(n.startswith("classifier.transformers.") for n in grads) == 6

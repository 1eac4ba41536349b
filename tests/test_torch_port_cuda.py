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
@pytest.mark.parametrize("e,q,u,dk,w,s,group", [
    (8, 5, 28, 1152, 5, 5, None),     # eval chunk at the flagship width
    (4, 25, 28, 1152, 5, 5, None),    # training micro-batch
    (16, 25, 28, 1152, 5, 5, None),   # MFM training step: 16 episodes, one launch
    (2, 3, 28, 100, 130, 1, None),    # ragged dk, W past 128
    (3, 11, 6, 128, 3, 2, None),
    (1, 1, 56, 64, 2, 5, None),       # U=56 (temp set 3)
    (1, 2, 120, 40, 3, 1, None),      # U=120: eight m16 tiles
    (2, 3, 28, 97, 5, 5, None),       # dk % 4 != 0: the 4-byte copy path
    (1, 3, 56, 1152, 5, 5, None),     # U=56 at the flagship dk: 18 score tiles a warp
    (4, 25, 8, 1152, 5, 5, None),     # CTX's training chunk: single frames, U=8
    (16, 25, 8, 1152, 5, 5, None),    # the composer's ctx head: a 16-episode step
    (4, 25, 56, 1152, 5, 5, None),    # TRX_multi/TRM's temp-set-3 chunk: U=56
    (16, 20, 28, 1152, 5, 5, None),   # the skeleton expert's 16-episode step
    (1, 5, 28, 1152, 5, 5, None),     # a served request: one episode
    (1, 2, 20, 64, 2, 32, None),      # 640 keys: three score passes, 16-column slices
    (2, 5, 28, 64, 3, 5, 5),          # G=5: 140 rows, two row passes
    (4, 25, 28, 1152, 5, 5, 1),       # the group sizes of the sweep
    (4, 25, 28, 1152, 5, 5, 2),
    (4, 25, 28, 1152, 5, 5, 4),       # a tail group of one query
    (3, 7, 28, 96, 4, 2, 4),          # a tail group of three queries
])
def test_kernel_matches_plain(cuda_device, e, q, u, dk, w, s, group):
    args = _inputs(q + w, cuda_device, e, q, u, dk, w, s)
    before = ta.tct_attention.launches
    got = (ta.tct_attention(*args) if group is None
           else ta._launch(*args, group=group))
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 1
    want = ta.tct_attention_plain(*args)
    assert got.shape == (e, q, w) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("e,q", [(8, 5), (4, 25)])
def test_kernel_is_bitwise_deterministic(cuda_device, e, q):
    args = _inputs(e * q, cuda_device, e, q, 28, 1152, 5, 5)
    first = ta.tct_attention(*args)
    assert torch.equal(ta.tct_attention(*args), first)


@pytest.mark.cuda
def test_kernel_takes_misaligned_operands(cuda_device):
    """Operands sliced from a larger buffer one float in: contiguous, but not
    16-byte aligned, so the kernel takes its 4-byte copies."""
    args = _inputs(3, cuda_device, 2, 5, 28, 1152, 5, 5)
    shifted = []
    for a in args:
        buf = torch.empty(a.numel() + 1, device=cuda_device)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        shifted.append(view)
    got = ta.tct_attention(*shifted)
    want = ta.tct_attention_plain(*args)
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
    # 4,096 keys of U=4: the 16 × 4,096 score tile exceeds shared memory
    wide = _inputs(1, cuda_device, 1, 1, 4, 8, 1, 1024)
    before = ta.tct_attention.launches
    with pytest.raises(ValueError, match="shared memory"):
        ta.tct_attention(*wide)
    with pytest.raises(ValueError, match="shared memory"):
        ta._launch(*args, group=512)
    assert ta.tct_attention.launches == before


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
    (16, 25, 28, 1152, 5, 5),   # MFM training step
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


def _mfm_tiny(cuda_device):
    """A tiny fp32 MFM teacher (dropout 0) on the CPU and its copy on the
    card, and one synthetic 2-episode batch."""
    import copy
    import dataclasses
    from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
    from litemkd_torch.train import create_mfm_train_state
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0))
    batch = SyntheticMultiModalSource(cfg, seed=1).sample_batch(
        np.random.default_rng(0), cfg.train.tasks_per_batch)
    cpu = create_mfm_train_state(cfg, "cpu")
    gpu = create_mfm_train_state(cfg, cuda_device,
                                 state_dict=copy.deepcopy(cpu.model.state_dict()))
    return cfg, batch, cpu, gpu


@pytest.mark.cuda
def test_mfm_forward_and_extract_on_card_match_cpu(cuda_device):
    """The tiny MFM teacher's logits (one TCT launch for both episodes) and
    its extracted features (no launch) on the card equal the CPU's within
    1e-4·max."""
    from litemkd_torch.train import to_device
    _, batch, cpu, gpu = _mfm_tiny(cuda_device)
    out = {}
    for state, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        b = to_device(batch, dev)
        model = state.model.eval()
        with torch.inference_mode():
            before = ta.tct_attention.launches
            logits = model(b.support_clips, b.support_labels, b.query_clips)
            mid = ta.tct_attention.launches
            feats = model.extract(b.query_clips)
            after = ta.tct_attention.launches
        out[str(dev)] = (logits["logits"].cpu(), feats.cpu(), mid - before,
                         after - mid)
    (lc, fc, _, _), (lg, fg, n_fwd, n_ext) = out["cpu"], out[str(cuda_device)]
    assert (n_fwd, n_ext) == (1, 0)
    assert (lg - lc).abs().max().item() <= 1e-4 * lc.abs().max().item()
    assert (fg - fc).abs().max().item() <= 1e-4 * fc.abs().max().item()


@pytest.mark.cuda
def test_mfm_train_step_on_card_matches_cpu(cuda_device):
    """One tiny MFM train step launches the TCT kernel once on the card;
    its metrics match the CPU's (1e-4 relative) and every gradient is
    within 1e-3·max|g| of the CPU's."""
    from litemkd_torch.train import make_mfm_train_step, to_device
    cfg, batch, cpu, gpu = _mfm_tiny(cuda_device)
    step = make_mfm_train_step(cfg)
    m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
    before = ta.tct_attention.launches
    m_gpu = step(gpu, to_device(batch, cuda_device))
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 1
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6, k
    grads = {n: p.grad for n, p in cpu.model.named_parameters()
             if p.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, p in gpu.model.named_parameters():
        if name not in grads:
            assert p.grad is None, name
            continue
        assert (p.grad.cpu() - grads[name]).abs().max().item() <= 1e-3 * g_max, name


@pytest.mark.cuda
@pytest.mark.parametrize("kind,launches", [("ThreeCross", 1),
                                           ("TwoCTXShuffleTime", 1),
                                           ("tsf", 3),
                                           ("OTAMThreeTRXShiftLoopTime", 0)])
def test_fusion_teacher_on_card_matches_cpu(cuda_device, kind, launches):
    """A tiny fp32 fusion teacher of ``kind`` (dropout 0) on the card: its
    logits equal the CPU's within 1e-4·max|logits|, with one TCT launch
    per TCT set of each head (TSF: one per modality; OTAM: none)."""
    import copy
    import dataclasses
    from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
    from litemkd_torch.train import create_mfm_train_state, to_device
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0))
    batch = SyntheticMultiModalSource(cfg, seed=1).sample_batch(
        np.random.default_rng(0), cfg.train.tasks_per_batch)
    cpu = create_mfm_train_state(cfg, "cpu", kind)
    gpu = create_mfm_train_state(cfg, cuda_device, kind,
                                 state_dict=copy.deepcopy(cpu.model.state_dict()))
    out = {}
    for state, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        b = to_device(batch, dev)
        with torch.inference_mode():
            before = ta.tct_attention.launches
            logits = state.model.eval()(b.support_clips, b.support_labels,
                                        b.query_clips)["logits"]
            out[str(dev)] = (logits.cpu(), ta.tct_attention.launches - before)
    (want, _), (got, n) = out["cpu"], out[str(cuda_device)]
    assert n == launches
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_checkpoint_dir_from_card_restores_on_cpu(cuda_device, tmp_path, caplog):
    """A directory that training on the card wrote (16-byte CUDA generator
    states) resumes with ``--device cpu``: the student run goes on to its
    end, and the MFM teacher's directory evaluates with ``--test_only``;
    both restores say that they reseeded the generators."""
    import logging
    from litemkd_torch.cli import train, train_teacher
    student, teacher = tmp_path / "student", tmp_path / "teacher"
    train.main(["--preset", "tiny", "--dataset", "synthetic", "-c", str(student),
                "--device", "cuda"])
    caplog.set_level(logging.WARNING)
    state, _ = train.main(["--preset", "tiny", "--dataset", "synthetic", "-c",
                           str(student), "-r", "--training_iterations", "8",
                           "--device", "cpu"])
    assert state.step == 4 and state.episodes_seen == 8
    train_teacher.main(["--preset", "tiny", "--dataset", "synthetic", "-c",
                        str(teacher), "--device", "cuda"])
    summary = train_teacher.main(["--test_only", "-m", str(teacher),
                                  "--device", "cpu"])
    assert summary["n_tasks"] == 2
    assert caplog.text.count("reseeded it from seed") == 3   # 2 student, 1 MFM


def _strm_tiny(cuda_device):
    """The tiny fp32 ``expert_strm`` student (the depth-18 ``strmbackbone``,
    ``strmclassifiers``, ``strm_expert``, dropout 0, the attention gate at
    0.75) on the CPU and its copy on the card, and one synthetic 2-episode
    batch."""
    import copy
    import dataclasses
    from litemkd_torch.cli.common import build_sampler
    from litemkd_torch.train import create_train_state
    base, expert = preset("tiny"), preset("expert_strm")
    cfg = base.replace(
        model=dataclasses.replace(base.model, compute_dtype="float32",
                                  trans_dropout=0.0, backbone="strmbackbone",
                                  classifier=expert.model.classifier),
        distill=expert.distill)
    batch = build_sampler(cfg, need_teacher=False).sample_batch(
        np.random.default_rng(0), cfg.train.tasks_per_batch)
    cpu = create_train_state(cfg, "cpu", with_teacher=False)
    with torch.no_grad():
        cpu.model.backbone.attn_pat.gamma.fill_(0.75)
        for m in cpu.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.fill_(3.0)
    gpu = create_train_state(cfg, cuda_device, with_teacher=False,
                             student_state_dict=copy.deepcopy(
                                 cpu.model.state_dict()))
    return cfg, batch, cpu, gpu


@pytest.mark.cuda
def test_expert_strm_on_card_matches_cpu(cuda_device):
    """The tiny ``expert_strm`` student on the card: its forward launches
    the TCT kernel once (the frame stream) and no BN kernel, and its 'pat'
    and 'fr' logits equal the CPU's within 1e-4·max; one training step
    launches the TCT kernel once, its metrics match the CPU's (1e-4
    relative) and every gradient is within 1e-3·max|g| of the CPU's. The
    forward runs in training mode, with batch statistics: in eval mode the
    running statistics (0 and 1 at init) leave the BN biases of 3 as a
    common offset that makes every clip's patch features nearly equal, and
    the distances between them, ‖a‖² + ‖b‖² − 2ab, fp32 rounding noise."""
    from litemkd_torch.ops import batch_norm as bn
    from litemkd_torch.train import make_train_step, to_device
    cfg, batch, cpu, gpu = _strm_tiny(cuda_device)
    out = {}
    for state, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        b = to_device(batch, dev)
        before = (ta.tct_attention.launches, bn.bn_sums.launches)
        with torch.no_grad():
            logits = state.model.train()(b.support_clips, b.support_labels,
                                         b.query_clips)["logits"]
        out[str(dev)] = ({k: v.cpu() for k, v in logits.items()},
                         (ta.tct_attention.launches - before[0],
                          bn.bn_sums.launches - before[1]))
    (lc, _), (lg, n) = out["cpu"], out[str(cuda_device)]
    assert n == (1, 0) and lg.keys() == lc.keys() == {"pat", "fr"}
    for k in lc:
        assert (lg[k] - lc[k]).abs().max().item() <= 1e-4 * lc[k].abs().max().item(), k
    step = make_train_step(cfg)
    m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
    before = (ta.tct_attention.launches, bn.bn_sums.launches)
    m_gpu = step(gpu, to_device(batch, cuda_device))
    torch.cuda.synchronize()
    assert (ta.tct_attention.launches - before[0],
            bn.bn_sums.launches - before[1]) == (1, 0)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6, k
    grads = {n: p.grad for n, p in cpu.model.named_parameters()
             if p.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    assert "backbone.attn_pat.gamma" in grads
    for name, p in gpu.model.named_parameters():
        if name not in grads:
            assert p.grad is None, name
            continue
        assert (p.grad.cpu() - grads[name]).abs().max().item() <= 1e-3 * g_max, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_vit_forward_on_card_matches_cpu(cuda_device, dtype, tol):
    """The deit_small ViT (12 blocks of width 384) at 224 px on the card,
    in fp32 (TF32 off) and under bf16 autocast, against the fp32 CPU
    forward of the same weights: logits within ``tol``·max|logit| (bf16
    rounds each block's products to 8 bits of mantissa)."""
    import dataclasses
    from litemkd_torch.train import make_pretrain_model
    from litemkd_torch.models import init_student_
    base = preset("tiny")
    cpu = make_pretrain_model(base.replace(
        episode=dataclasses.replace(base.episode, img_size=224),
        model=dataclasses.replace(base.model, compute_dtype="float32")),
        7, "deit_small")
    init_student_(cpu, torch.Generator().manual_seed(0))
    gpu = make_pretrain_model(base.replace(
        episode=dataclasses.replace(base.episode, img_size=224),
        model=dataclasses.replace(base.model, compute_dtype=str(dtype)[6:])),
        7, "deit_small")
    gpu.load_state_dict(cpu.state_dict())
    clips = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 3, 224, 224, 3), np.uint8))
    with torch.inference_mode():
        want = cpu.eval()(clips)
        got = gpu.to(cuda_device).eval()(clips.to(cuda_device)).float().cpu()
    assert got.shape == (2, 7)
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TRX_sup", "TRX_2fc", "TRX_2fcsup_2", "OTAM",
                                  "TRX_multi", "CTX", "CTX_videoaxis"])
def test_zoo_head_on_card_matches_cpu(cuda_device, name):
    """Each head class of the student zoo at tiny width in fp32 on the card
    against the same weights and features on the CPU: every output within
    1e-4·max, and the TCT kernel launched as often as the CPU model calls
    the kernel's wrapper (TRX_sup's prototypes and OTAM take none)."""
    import copy
    import dataclasses
    from litemkd_torch.models import init_student_, make_classifier
    from litemkd_torch.ops import tct as tct_mod
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0, temp_set=(2, 3)))
    ep = cfg.episode
    cpu = make_classifier(name, cfg).eval()
    init_student_(cpu, torch.Generator().manual_seed(1))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(2)
    streams = ("f1", "f2") if name in ("TRX_2fc", "TRX_2fcsup_2") else (None,)

    def feats(n):
        out = {k: torch.from_numpy(rng.normal(size=(
            2, n, ep.seq_len, cfg.model.trans_linear_in_dim)).astype(np.float32))
            for k in streams}
        return out[None] if streams == (None,) else out

    def to(x, dev):
        return {k: v.to(dev) for k, v in x.items()} if isinstance(x, dict) else x.to(dev)

    args = (feats(ep.way * ep.shot),
            torch.arange(ep.way).repeat_interleave(ep.shot).repeat(2, 1),
            feats(ep.way * ep.query_per_class))
    calls = []
    real = tct_mod.tct_attention
    try:
        tct_mod.tct_attention = lambda *a: calls.append(1) or real(*a)
        with torch.no_grad():
            want = cpu(*args)
    finally:
        tct_mod.tct_attention = real
    before = ta.tct_attention.launches
    with torch.no_grad():
        got = gpu(*(to(a, cuda_device) for a in args))
    torch.cuda.synchronize()
    assert ta.tct_attention.launches - before == len(calls)
    want, got = (x if isinstance(x, dict) else {"logits": x} for x in (want, got))
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].cpu() - want[k]).abs().max().item() <= \
            1e-4 * want[k].abs().max().item(), k


@pytest.mark.cuda
def test_mobilenet_student_chunk_on_card_matches_cpu(cuda_device):
    """The tiny fp32 ``student_mobilenet`` (MobileNetV3-large 2-fc,
    TRX_2fcsup) over a chunk of 2 episodes at 64 px in training mode on the
    card: both feature streams within 1e-4·max of the CPU's; on the card's
    own features the TCT kernel within 1e-4·max of its plain version for
    both branches; a full forward launches the TCT kernel twice (kl, ce)
    and no BN kernel. The logits are not held against the CPU's: at this
    width the TCT's LayerNorm over near-equal keys amplifies fp32 rounding
    of the features (the CPU's own fp32 logits differ from its float64 ones
    by up to 30% of their largest value)."""
    import copy
    import dataclasses
    from litemkd_torch.models import BatchedStudent, init_student_
    from litemkd_torch.ops import batch_norm as bn
    base = preset("tiny")
    mob = preset("student_mobilenet")
    cfg = base.replace(
        episode=dataclasses.replace(base.episode, img_size=64),
        model=dataclasses.replace(base.model, compute_dtype="float32",
                                  backbone=mob.model.backbone,
                                  classifier=mob.model.classifier))
    ep = cfg.episode
    cpu = BatchedStudent(cfg).train()
    init_student_(cpu, torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(4)
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = torch.from_numpy(rng.integers(0, 256, (2, ep.way * ep.shot, *shape),
                                        dtype=np.uint8))
    qry = torch.from_numpy(rng.integers(0, 256, (2, ep.way * ep.query_per_class,
                                                 *shape), dtype=np.uint8))
    lab = torch.arange(ep.way).repeat_interleave(ep.shot).repeat(2, 1)
    dev = [x.to(cuda_device) for x in (sup, lab, qry)]
    with torch.no_grad():
        want = cpu.features(sup, qry)
        got = gpu.features(dev[0], dev[2])
        for g, w in zip(got, want):
            for s in ("f1", "f2"):
                assert (g[s].cpu() - w[s]).abs().max().item() <= \
                    1e-4 * w[s].abs().max().item(), s
        tct = gpu.classifier.transformers
        for s in ("f1", "f2"):
            ops = tct.project(got[0][s], dev[1], got[1][s])
            k, p = ta.tct_attention(*ops), ta.tct_attention_plain(*ops)
            assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item(), s
        before = (ta.tct_attention.launches, bn.bn_sums.launches)
        out = gpu(*dev)["logits"]
    torch.cuda.synchronize()
    assert (ta.tct_attention.launches - before[0],
            bn.bn_sums.launches - before[1]) == (2, 0)
    assert out.keys() == {"kl", "ce", "sup"}
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.cuda
def test_tct_op_passes_opcheck_on_card(cuda_device):
    """``litemkd::tct_attention`` on CUDA tensors: schema, fake tensor,
    autograd registration and AOT dispatch, with and without inputs that
    need a gradient."""
    args = _inputs(1, cuda_device, 2, 3, 28, 64, 5, 5)
    for a in (args, [x.clone().requires_grad_(True) for x in args]):
        res = torch.library.opcheck(torch.ops.litemkd.tct_attention.default, a)
        assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.cuda
def test_scorer_artifact_on_card_launches_kernel_twice(cuda_device, tmp_path):
    """A tiny scorer artifact traced on the card holds 2 TCT op nodes,
    launches nothing while it is traced, launches the kernel twice a call
    when it runs, and gives the eager student's logits within 1e-3 of
    their largest magnitude (cuDNN may pick other algorithms)."""
    from litemkd_torch.cli.test import load_student
    from litemkd_torch.tools import aot
    cfg = preset("tiny")
    model = load_student(cfg, None, cuda_device)
    path = str(tmp_path / "scorer.litemkd")
    before = ta.tct_attention.launches
    aot.export_serving_artifact(cfg, model, path, cuda_device, episodes=2)
    assert ta.tct_attention.launches == before
    assert aot.op_nodes(aot.load_program(path)[0]) == 2
    scorer, manifest = aot.load_serving_artifact(path)
    assert manifest["platforms"] == ["cuda"]
    ep = cfg.episode
    rng = np.random.default_rng(0)
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = torch.from_numpy(rng.integers(0, 256, (2, ep.n_support, *shape),
                                        dtype=np.uint8)).to(cuda_device)
    qry = torch.from_numpy(rng.integers(0, 256, (2, ep.n_queries(False), *shape),
                                        dtype=np.uint8)).to(cuda_device)
    lab = torch.arange(ep.way, device=cuda_device).repeat_interleave(
        ep.shot).repeat(2, 1)
    for _ in range(2):
        before = ta.tct_attention.launches
        got = scorer(sup, lab, qry)
        torch.cuda.synchronize()
        assert ta.tct_attention.launches == before + 2
    with torch.inference_mode():
        want = aot.make_serving_fn(cfg, model)(sup, lab, qry)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * want.abs().max().item())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (litemkd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back to the CPU):
1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the port from ``litemkd_torch/csrc/``,
   one nvcc process per source, all at once;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes and at ragged ones, and time the kernel, the
   plain version and one library call computing the same function, beside
   the bound; the TCT kernel's autograd Function against autograd through
   the plain version at the training shape; then the eval slice and one
   train step at tiny width in fp32 on the card against the same weights
   and episodes on the CPU, the reference that the CPU tests hold equal to
   the JAX package;
4. eval path: full-width ``student_fc2sup_dist`` episodic eval (bf16 trunk,
   224 px, 16 synthetic episodes) through ``litemkd_torch.cli.test.main``,
   with the launch counts read around it; then one chunk's features through
   kernel and plain version, which must give the same accuracies; then the
   device-resident eval rate;
5. training path: full-width ``student_fc2sup_dist`` training with the BN
   kernels on (2 steps of 16 episodes, micro-batch 4, an 8-episode eval at
   the end) through ``litemkd_torch.cli.train.main``, with the launch
   counts read around it; the checkpoint it wrote through the eval CLI;
   then the device-resident training rate with the BN kernels and with
   cuDNN.
It prints a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.
"""
import copy
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from litemkd_torch import preset
from litemkd_torch.cli import test as cli_test
from litemkd_torch.cli import train as cli_train
from litemkd_torch.cli.common import build_sampler
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.distill import merge_logits
from litemkd_torch.ops import _build
from litemkd_torch.ops import batch_norm as bn
from litemkd_torch.ops import tct_attention as ta
from litemkd_torch.ops.distances import support_dk_logits
from litemkd_torch.train import EpisodeBatch, create_train_state, make_train_step
from litemkd_torch.train.loop import to_device
from litemkd_torch.utils.metrics import per_episode_accuracy

FP32_PEAK = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12    # H100 SXM HBM3 bytes/s
EVAL = dict(e=8, q=5, u=28, dk=1152, w=5, s=5)    # main path: 8-episode eval chunk
TRAIN = dict(e=4, q=25, u=28, dk=1152, w=5, s=5)  # training micro-batch of 4
RAGGED = [dict(e=2, q=3, u=28, dk=100, w=130, s=1),
          dict(e=3, q=11, u=28, dk=100, w=7, s=3)]
N_TASKS = 16
# noise 1.0 keeps accuracy off 100% (at the default 0.3 every episode of the
# random-weight student scores 1.0), so equal accuracies say something
MAIN_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
             "--num_test_tasks", str(N_TASKS), "--synthetic_noise", "1.0",
             "--device", "cuda"]
# BN layers of one training chunk (4 episodes × 50 clips × 8 frames = 1,600
# frames at 224 px): (count per chunk, H, W, C)
BN_LAYERS = [("stem", 1, 112, 112, 64), ("layer1", 4, 56, 56, 64),
             ("layer2", 5, 28, 28, 128), ("layer3", 5, 14, 14, 256),
             ("layer4", 5, 7, 7, 512)]
CHUNK_FRAMES = 1600
BN_RAGGED = [(210, 16), (1000, 100), (4096, 2048)]
TRAIN_EPISODES, TRAIN_STEPS, EVAL_TASKS = 16, 2, 8
TRAIN_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
              "--pallas_bn", "--training_iterations",
              str(TRAIN_EPISODES * TRAIN_STEPS), "--test_iters",
              str(TRAIN_EPISODES * TRAIN_STEPS), "--num_test_tasks",
              str(EVAL_TASKS), "--print_freq", "1", "--device", "cuda"]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tct_inputs(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    e, q, u, dk, w, s = (shape[k] for k in ("e", "q", "u", "dk", "w", "s"))
    return [torch.randn(sz, generator=g, device="cuda") for sz in
            ((e, q, u, dk), (e, q, u, dk), (e, w, s, u, dk), (e, w, s, u, dk))]


def tct_library(q_k, q_v, class_k, class_v):
    """The same function through one fused library attention call (a
    yardstick only; the port never calls it)."""
    e, q, u, dk = q_k.shape
    w, s = class_k.shape[1], class_k.shape[2]
    query = q_k.reshape(e, 1, q * u, dk).expand(e, w, q * u, dk)
    proto = F.scaled_dot_product_attention(
        query, class_k.reshape(e, w, s * u, dk), class_v.reshape(e, w, s * u, dk))
    diff = q_v.reshape(e, 1, q * u, dk) - proto
    dist = (diff * diff).reshape(e, w, q, u * dk).sum(-1) / u
    return -dist.transpose(1, 2)


def tct_bound(shape):
    e, q, u, dk, w, s = (shape[k] for k in ("e", "q", "u", "dk", "w", "s"))
    flops = 4 * e * w * (q * u) * (s * u) * dk        # two products, 2 flop per FMA
    nbytes = 4 * (2 * e * q * u * dk + 2 * e * w * s * u * dk + e * q * w)
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(shape, seed):
    args = tct_inputs(shape, seed)
    got = ta.tct_attention(*args)
    torch.cuda.synchronize()
    want = ta.tct_attention_plain(*args)
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    log(f"[kernel] tct_attention {shape}: max_abs_err={err:.3e} tol={tol:.3e}")
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"tct_attention disagrees with its plain version "
                             f"at {shape}: {err} > {tol}")
    return args, err


def time_kernel(shape, args):
    kernel_ms = cuda_ms(lambda: ta.tct_attention(*args), 50)
    plain_ms = cuda_ms(lambda: ta.tct_attention_plain(*args), 10)
    library_ms = cuda_ms(lambda: tct_library(*args), 20)
    lib_err = (tct_library(*args) - ta.tct_attention_plain(*args)).abs().max().item()
    bound_ms, bound_by = tct_bound(shape)
    log(f"[kernel] tct_attention {shape}: kernel_ms={kernel_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) library_max_abs_err={lib_err:.3e}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def one_chunk_check(cfg, device):
    """The CLI's first chunk through the model, with both TCT branches
    computed by the kernel and by the plain version on the same features."""
    model = cli_test.load_student(cfg, None, device)
    sampler = build_sampler(cfg, need_teacher=False)
    batch = to_device(sampler.sample_batch(np.random.default_rng(cfg.train.seed),
                                           8, train=False), device)
    tct = model.classifier.transformers
    ep = cfg.episode
    with torch.inference_mode():
        ctx, tgt = model.features(batch.support_clips, batch.query_clips)
        sup = support_dk_logits(ctx["f2"], batch.support_labels, ep.way,
                                ep.shot, ep.seq_len)
        kernel, plain = {"sup": sup}, {"sup": sup}
        for branch, f in (("kl", "f1"), ("ce", "f2")):
            ops = tct.project(ctx[f], batch.support_labels, tgt[f])
            kernel[branch] = ta.tct_attention(*ops)
            plain[branch] = ta.tct_attention_plain(*ops)
        mk = merge_logits(cfg.distill.name, kernel)
        mp = merge_logits(cfg.distill.name, plain)
        full = merge_logits(cfg.distill.name, model(
            batch.support_clips, batch.support_labels, batch.query_clips)["logits"])
        for v in list(kernel.values()) + [mk]:
            if not torch.isfinite(v).all():
                raise AssertionError("non-finite logits on the main path")
        err = (mk - mp).abs().max().item()
        tol = 1e-4 * mp.abs().max().item()
        acc_k = per_episode_accuracy(mk, batch.query_labels)
        acc_p = per_episode_accuracy(mp, batch.query_labels)
    log(f"[main] one chunk: merged logits max_abs_err={err:.3e} tol={tol:.3e}; "
        f"accuracies kernel={acc_k.tolist()} plain={acc_p.tolist()}")
    if not err <= tol:
        raise AssertionError(f"merged logits differ: {err} > {tol}")
    if not torch.equal(acc_k, acc_p):
        raise AssertionError("per-episode accuracies differ between kernel and plain")
    if not torch.equal(full, mk):
        raise AssertionError("model forward differs from its own kernel branches")
    return model, batch


def reference_check():
    """The slice at tiny width in fp32 (tiny preset, 8 episodes, noise 4.0
    so accuracies sit mid-curve) on the card against the same weights and
    episodes on the CPU. Tolerance 1e-4·max|cpu| per branch: fp32 on both
    sides with TF32 off, sums taken in another order."""
    base = preset("tiny")
    cfg = base.replace(
        model=dataclasses.replace(base.model, compute_dtype="float32"),
        data=dataclasses.replace(base.data, synthetic_noise=4.0))
    cpu_model = cli_test.load_student(cfg, None, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = build_sampler(cfg, need_teacher=False).sample_batch(
        np.random.default_rng(0), 8, train=False)
    want, got = {}, {}
    for model, dev, out in ((cpu_model, "cpu", want), (gpu_model, "cuda", got)):
        b = to_device(batch, torch.device(dev))
        with torch.inference_mode():
            out.update(model(b.support_clips, b.support_labels, b.query_clips)["logits"])
        out["acc"] = per_episode_accuracy(merge_logits(cfg.distill.name, out),
                                          b.query_labels).cpu()
    errs = {}
    for k in ("kl", "ce", "sup"):
        errs[k] = (got[k].cpu() - want[k]).abs().max().item()
        tol = 1e-4 * want[k].abs().max().item()
        if not (math.isfinite(errs[k]) and errs[k] <= tol):
            raise AssertionError(f"tiny slice on cuda vs cpu, branch {k}: "
                                 f"{errs[k]} > {tol}")
    log("[reference] tiny fp32 slice, cuda vs cpu: max_abs_err "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f"; accuracies cuda={got['acc'].tolist()} cpu={want['acc'].tolist()}")
    if not torch.equal(got["acc"], want["acc"]):
        raise AssertionError("tiny slice: accuracies differ between cuda and cpu")


def device_rate(model, batch, card):
    """Steady-state eval rate on a device-resident 8-episode chunk, and the
    split between trunk and heads."""
    with torch.inference_mode():
        step_ms = cuda_ms(lambda: model(batch.support_clips, batch.support_labels,
                                        batch.query_clips), 5, warmup=1)
        trunk_ms = cuda_ms(lambda: model.features(batch.support_clips,
                                                  batch.query_clips), 5, warmup=1)
    e = batch.support_clips.shape[0]
    log(f"[main] device-resident eval on {card}: {1e3 * e / step_ms:.3f} episodes/s "
        f"({step_ms:.3f} ms per {e}-episode chunk; trunk {trunk_ms:.3f} ms, "
        f"heads {step_ms - trunk_ms:.3f} ms); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


# ---------------------------------------------------------------------------
# BN-moment kernels
# ---------------------------------------------------------------------------

def bn_bound(r, c, elt, bwd):
    """Least time for the sums on this card: every input read once, the
    (2, C) output written once, against 3 (forward) or 6 (backward) fp32
    operations per element outside the tensor cores."""
    nbytes = (2 if bwd else 1) * r * c * elt + (6 if bwd else 2) * c * 4
    flops = (6 if bwd else 3) * r * c
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def bn_inputs(r, c, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(r, c, generator=g, device="cuda", dtype=dtype).mul_(2).add_(0.5)
    dy = torch.randn(r, c, generator=g, device="cuda", dtype=dtype)
    sums = bn.bn_sums_plain(x)
    mean = sums[0] / r
    inv = torch.rsqrt(torch.clamp_min(sums[1] / r - mean * mean, 0) + 1e-5)
    return x, dy, mean, inv


def check_bn(r, c, dtype, seed):
    """Both kernels against their plain versions at (r, c): per channel,
    |kernel − plain| ≤ 1e-5·Σ|term| + 1e-6 (fp32 sums of r terms taken in
    another order), and a second run bitwise equal to the first. Returns
    the inputs and the largest absolute error."""
    x, dy, mean, inv = bn_inputs(r, c, dtype, seed)
    got, got_b = bn.bn_sums(x), bn.bn_bwd_sums(dy, x, mean, inv)
    torch.cuda.synchronize()
    want, want_b = bn.bn_sums_plain(x), bn.bn_bwd_sums_plain(dy, x, mean, inv)
    f32 = torch.float32
    tols = [1e-5 * torch.sum(x.abs(), 0, dtype=f32), 1e-5 * want[1],
            1e-5 * torch.sum(dy.abs(), 0, dtype=f32),
            1e-5 * (dy.float() * ((x.float() - mean) * inv)).abs().sum(0)]
    errs = [(got[0] - want[0]).abs(), (got[1] - want[1]).abs(),
            (got_b[0] - want_b[0]).abs(), (got_b[1] - want_b[1]).abs()]
    names = ["sum x", "sum x^2", "sum dy", "sum dy*xhat"]
    for name, err, tol in zip(names, errs, tols):
        if not (torch.isfinite(err).all() and (err <= tol + 1e-6).all()):
            raise AssertionError(f"bn kernels disagree with plain at ({r}, {c}) "
                                 f"{dtype}, {name}: max err {err.max().item()}")
    if not (torch.equal(bn.bn_sums(x), got)
            and torch.equal(bn.bn_bwd_sums(dy, x, mean, inv), got_b)):
        raise AssertionError(f"bn kernels are not deterministic at ({r}, {c})")
    err = max(e.max().item() for e in errs)
    rel = max((e / (t + 1e-6)).max().item() for e, t in zip(errs, tols))
    log(f"[kernel] bn sums ({r}, {c}) {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"(at most {rel:.3f} of the tolerance); deterministic")
    return (x, dy, mean, inv), err


def time_bn(name, h, w, c, inputs):
    """Kernel, plain and library times of both sums at one layer's shape.
    The library yardsticks (never called by the port) are
    torch.batch_norm_stats and torch.batch_norm_backward_reduce on the same
    channels-last activation."""
    x, dy, mean, inv = inputs
    r = x.shape[0]
    n = r // (h * w)
    x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
    dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
    weight = torch.ones(c, device="cuda")
    iters = 5 if r > 10_000_000 else 20
    out = {}
    for key, kernel, plain, library, bwd in (
            ("sums", lambda: bn.bn_sums(x), lambda: bn.bn_sums_plain(x),
             lambda: torch.batch_norm_stats(x4, 1e-5), False),
            ("bwd_sums", lambda: bn.bn_bwd_sums(dy, x, mean, inv),
             lambda: bn.bn_bwd_sums_plain(dy, x, mean, inv),
             lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, inv, weight,
                                                      True, True, True), True)):
        bound_ms, bound_by = bn_bound(r, c, x.element_size(), bwd)
        out[key] = dict(ms=cuda_ms(kernel, iters), plain_ms=cuda_ms(plain, iters),
                        library_ms=cuda_ms(library, iters), bound_ms=bound_ms,
                        bound_by=bound_by)
        t = out[key]
        log(f"[kernel] bn_{key} {name} (R={r}, C={c}, {str(x.dtype)[6:]}): "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({bound_by}) at {100 * bound_ms / t['ms']:.1f}% of the bound")
    return out


def bn_phase():
    """The five BN shapes of a training chunk in bf16, timed, and the ragged
    shapes in fp32 and bf16. Returns per-chunk totals (each layer's time ×
    its BatchNorms per chunk) and the largest error."""
    totals = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
              for k in ("sums", "bwd_sums")}
    err_max = 0.0
    for i, (name, count, h, w, c) in enumerate(BN_LAYERS):
        inputs, err = check_bn(CHUNK_FRAMES * h * w, c, torch.bfloat16, 10 + i)
        err_max = max(err_max, err)
        times = time_bn(name, h, w, c, inputs)
        del inputs
        for key, t in times.items():
            for k in totals[key]:
                totals[key][k] += count * t[k]
            totals[key]["bound_by"] = t["bound_by"]
    for i, (r, c) in enumerate(BN_RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            check_bn(r, c, dtype, 20 + i)
    for key, t in totals.items():
        log(f"[kernel] bn_{key} per training chunk (20 BatchNorms): "
            f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f}")
    torch.cuda.empty_cache()
    return totals, err_max


def tct_grad_check(shape, seed):
    """The TCT autograd Function on the card (kernel forward, plain
    recompute backward) against autograd through the plain version: the
    logits carry a grad_fn and the four operand gradients agree within
    1e-4·max|plain|. Times the backward recompute."""
    args = tct_inputs(shape, seed)
    g = torch.randn(shape["e"], shape["q"], shape["w"], device="cuda")
    ops = [a.clone().requires_grad_(True) for a in args]
    out = ta.tct_attention(*ops)
    if out.grad_fn is None:
        raise AssertionError("the TCT kernel's logits carry no gradient")
    out.backward(g)
    ref = [a.clone().requires_grad_(True) for a in args]
    ta.tct_attention_plain(*ref).backward(g)
    errs = []
    for got, want in zip(ops, ref):
        err = (got.grad - want.grad).abs().max().item()
        tol = 1e-4 * want.grad.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"TCT gradient disagrees: {err} > {tol}")
        errs.append(err)
    bwd_ms = cuda_ms(lambda: ta.tct_attention_backward_plain(g, *args), 10)
    log(f"[kernel] tct_attention backward {shape}: max_abs_err "
        + ", ".join(f"{e:.3e}" for e in errs)
        + f"; plain recompute backward_ms={bwd_ms:.4f}")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _max_err(got, want):
    return (got.detach().cpu() - want.detach().cpu()).abs().max().item()


def train_reference_check():
    """One train step of the tiny preset in fp32 with the BN kernels on,
    dropout 0 and the teacher, on the card against the same weights and
    batch on the CPU. BN biases start at +3, so no pre-activation sits at a
    ReLU kink (there a last-bit difference flips a mask). Tolerances:
    metrics 1e-4 relative; gradients 1e-3·max|g| over all parameters;
    running statistics 1e-4·max; updated parameters the learning rate
    times the gradients' tolerance, + 1e-6·max|p|."""
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", pallas_bn=True, trans_dropout=0.0))
    batch = build_sampler(cfg).sample_batch(np.random.default_rng(0),
                                            cfg.train.tasks_per_batch)
    cpu = create_train_state(cfg, "cpu")
    with torch.no_grad():
        for m in cpu.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.bias.fill_(3.0)
    gpu = create_train_state(cfg, "cuda", student_state_dict=cpu.model.state_dict(),
                             teacher_state_dict=cpu.teacher.state_dict())
    step = make_train_step(cfg)
    m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
    m_gpu = step(gpu, to_device(batch, torch.device("cuda")))
    torch.cuda.synchronize()
    for k, v in m_cpu.items():
        if not abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6:
            raise AssertionError(f"train step metric {k}: cuda {m_gpu[k].item()} "
                                 f"vs cpu {v.item()}")
    gp = dict(gpu.model.named_parameters())
    grads = {n: p.grad for n, p in cpu.model.named_parameters() if p.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    g_err = max(_max_err(gp[n].grad, g) for n, g in grads.items())
    if not g_err <= 1e-3 * g_max:
        raise AssertionError(f"train step gradients: {g_err} > 1e-3 * {g_max}")
    p_err, lr = 0.0, cfg.train.learning_rate
    for n, p in cpu.model.named_parameters():
        err, p_max = _max_err(gp[n], p), p.abs().max().item()
        if not err <= lr * 1e-3 * g_max + 1e-6 * p_max:
            raise AssertionError(f"updated parameter {n} differs by {err}")
        p_err = max(p_err, err / max(p_max, 1e-9))
    gb = dict(gpu.model.named_buffers())
    s_err = 0.0
    for n, b in cpu.model.named_buffers():
        if n.endswith(("running_mean", "running_var")):
            err = _max_err(gb[n], b)
            if not err <= 1e-4 * b.abs().max().item():
                raise AssertionError(f"running statistic {n}: {err}")
            s_err = max(s_err, err / b.abs().max().item())
    log(f"[reference] tiny fp32 train step, cuda vs cpu: metrics "
        + ", ".join(f"{k}={m_gpu[k].item():.6g}/{v.item():.6g}" for k, v in m_cpu.items())
        + f"; grads max_abs_err={g_err:.3e} (max|g|={g_max:.3e}); running stats "
        f"{s_err:.3e} of max; updated params {p_err:.3e} of max")


def read_counts():
    return dict(tct_attention=ta.tct_attention.launches,
                bn_sums=bn.bn_sums.launches, bn_bwd_sums=bn.bn_bwd_sums.launches)


def zero_counts():
    ta.tct_attention.launches = 0
    bn.bn_sums.launches = 0
    bn.bn_bwd_sums.launches = 0


def train_main_path(card, run_root):
    """Full-width training through the CLI with the launch counts read
    around it; then the checkpoint it wrote through the eval CLI."""
    ckdir = run_root / "run"
    draw = [0.0]
    sample_batch = SyntheticEpisodeSource.sample_batch

    def timed(self, *a, **k):
        t = time.perf_counter()
        out = sample_batch(self, *a, **k)
        draw[0] += time.perf_counter() - t
        return out

    SyntheticEpisodeSource.sample_batch = timed
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        t0 = time.perf_counter()
        _, history = cli_train.main(TRAIN_ARGV + ["-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        SyntheticEpisodeSource.sample_batch = sample_batch
    cfg = cli_train.parse(TRAIN_ARGV)[1]
    chunks = TRAIN_STEPS * TRAIN_EPISODES // (cfg.train.micro_batch or TRAIN_EPISODES)
    eval_chunks = math.ceil(EVAL_TASKS / 8)
    want = dict(tct_attention=3 * chunks + 2 * eval_chunks, bn_sums=20 * chunks,
                bn_bwd_sums=20 * chunks)
    log(f"[train] launches {counts} over {chunks} training chunks and "
        f"{eval_chunks} eval chunk(s); expected {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    records = [json.loads(line) for f in ckdir.glob("*.jsonl")
               for line in f.read_text().splitlines()]
    steps = [r for r in records if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad mid-training eval {history}")
    log("[train] per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "soft_loss", "hard_loss",
                            "accuracy")} for r in steps]))
    n_eps = TRAIN_STEPS * TRAIN_EPISODES
    log(f"[train] CLI training on {card}: {n_eps / wall:.3f} episodes/s end to "
        f"end ({wall:.2f} s for {n_eps} training + {EVAL_TASKS} eval episodes; "
        f"host synthetic draws {draw[0]:.2f} s, "
        f"{n_eps / (wall - draw[0]):.3f} episodes/s without them); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ckpt = ckdir / f"checkpoint_{n_eps}.pt"
    summary = cli_test.main(["-m", str(ckpt), "--num_test_tasks", "8",
                             "--device", "cuda"])
    if summary["n_tasks"] != 8 or not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"bad eval of the trained checkpoint {summary}")
    log(f"[train] {ckpt.name} through the eval CLI: {summary}")
    return counts


def device_batch(cfg, e, seed=0):
    """A training batch made on the card: uint8 clips, shuffled labels with
    each class ``shot`` (``query_per_class``) times, fused teacher
    features."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ep = cfg.episode
    s, q = ep.way * ep.shot, ep.way * ep.query_per_class
    frame = (ep.seq_len, ep.img_size, ep.img_size, 3)

    def labels(n):
        return torch.stack([torch.randperm(n, generator=g, device="cuda") % ep.way
                            for _ in range(e)])

    def clips(n):
        return torch.randint(0, 256, (e, n, *frame), generator=g, device="cuda",
                             dtype=torch.uint8)

    def feats(n):
        return torch.randn((e, n, ep.seq_len, cfg.model.trans_linear_in_dim),
                           generator=g, device="cuda")

    return EpisodeBatch(clips(s), labels(s), clips(q), labels(q), feats(s), feats(q))


def profile_step(fn, label):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    union of its kernel and copy intervals), the span from the first device
    start to the last device end, the idle share of that span, and the
    kernels that take the most device time. Prints "not measured" where the
    profiler records no device activity."""
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as e:   # a measurement, not a result: report and go on
        log(f"[profile] {label}: profiler failed ({e!r}); not measured")
        return
    if not dev:
        log(f"[profile] {label}: no device activity recorded; not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - spans[0][0]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] {label}: device busy {busy / 1e3:.3f} ms of a "
        f"{span / 1e3:.3f} ms span (idle share {1 - busy / span:.3f}); "
        f"{len(dev)} device events; top: "
        + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top))


def train_device_rate(card):
    """Steady-state training rate on one 16-episode batch already on the
    card (CUDA events over 3 steps after one warm-up), with the BN kernels
    and with cuDNN BatchNorm, and the peak memory of each; then one step of
    each under the profiler."""
    for pallas_bn in (True, False):
        base = preset("student_fc2sup_dist")
        cfg = base.replace(model=dataclasses.replace(base.model, pallas_bn=pallas_bn))
        state = create_train_state(cfg, "cuda")
        batch = device_batch(cfg, TRAIN_EPISODES)
        step = make_train_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
        log(f"[train] device-resident training on {card}, "
            f"{'BN kernels' if pallas_bn else 'cuDNN BatchNorm'}: "
            f"{1e3 * TRAIN_EPISODES / ms:.3f} episodes/s ({ms:.3f} ms per "
            f"{TRAIN_EPISODES}-episode step of "
            f"{TRAIN_EPISODES // (cfg.train.micro_batch or TRAIN_EPISODES)} "
            f"chunks); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        profile_step(lambda: step(state, batch),
                     f"training step, {'BN kernels' if pallas_bn else 'cuDNN BatchNorm'}")
        del state, batch
        torch.cuda.empty_cache()


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])

    # 2. build: every kernel library at once
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions, then the tiny slices
    args, err_eval = check_kernel(EVAL, 0)
    eval_times = time_kernel(EVAL, args)
    train_args, _ = check_kernel(TRAIN, 1)
    time_kernel(TRAIN, train_args)
    del args, train_args
    for i, shape in enumerate(RAGGED):
        check_kernel(shape, 2 + i)
    tct_grad_check(TRAIN, 5)
    tct_grad_check(RAGGED[0], 6)
    bn_times, bn_err = bn_phase()
    reference_check()
    train_reference_check()

    # 4. eval path through the CLI, launch counts read around it
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    summary = cli_test.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eval_counts = read_counts()
    n_chunks = math.ceil(N_TASKS / 8)
    log(f"[main] eval launches {eval_counts} over {n_chunks} chunks")
    if eval_counts != dict(tct_attention=2 * n_chunks, bn_sums=0, bn_bwd_sums=0):
        raise AssertionError(f"expected {2 * n_chunks} TCT launches and no BN "
                             f"kernel in eval, got {eval_counts}")
    if summary["n_tasks"] != N_TASKS or not (
            math.isfinite(summary["accuracy"]) and math.isfinite(summary["confidence"])):
        raise AssertionError(f"bad eval summary {summary}")
    log(f"[main] CLI eval on {card}: {N_TASKS / wall:.3f} episodes/s end to end "
        f"({wall:.2f} s, synthetic data drawn on the host included)")
    _, cfg = cli_test.parse(MAIN_ARGV)
    model, batch = one_chunk_check(cfg, torch.device("cuda"))
    device_rate(model, batch, card)
    del model, batch
    torch.cuda.empty_cache()

    # 5. training path through the CLI, launch counts read around it
    run_root = Path(__file__).resolve().parent / ".chip_smoke"
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        counts = train_main_path(card, run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    train_device_rate(card)

    print(json.dumps({"kernels": [
        dict(name="tct_attention", route="cuda",
             source="litemkd_torch/csrc/tct_attention.cu",
             replaces="litemkd_tpu/ops/pallas_tct.py:61",
             launches=counts["tct_attention"], max_abs_err=err_eval, **eval_times),
        dict(name="bn_sums", route="cuda", source="litemkd_torch/csrc/bn_moments.cu",
             replaces="litemkd_tpu/ops/pallas_bn.py:73",
             launches=counts["bn_sums"], max_abs_err=bn_err, **bn_times["sums"]),
        dict(name="bn_bwd_sums", route="cuda",
             source="litemkd_torch/csrc/bn_moments.cu",
             replaces="litemkd_tpu/ops/pallas_bn.py:103",
             launches=counts["bn_bwd_sums"], max_abs_err=bn_err,
             **bn_times["bwd_sums"])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

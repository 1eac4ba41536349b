#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (litemkd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back to the CPU):
1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the port from ``litemkd_torch/csrc/``;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main path's shapes and at ragged ones, and time the kernel, the
   plain version and one library call computing the same function;
   then the whole slice at tiny width in fp32 on the card against the same
   weights and episodes on the CPU, the reference that the CPU tests hold
   equal to the JAX package;
4. main path: full-width ``student_fc2sup_dist`` episodic eval (bf16 trunk,
   224 px, 16 synthetic episodes) through ``litemkd_torch.cli.test.main``,
   with the launch counts read around it; then one chunk's features through
   kernel and plain version, which must give the same accuracies; then the
   device-resident eval rate.
It prints a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.
"""
import copy
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from litemkd_torch import preset
from litemkd_torch.cli import test as cli_test
from litemkd_torch.cli.common import build_sampler
from litemkd_torch.distill import merge_logits
from litemkd_torch.ops import tct_attention as ta
from litemkd_torch.ops.distances import support_dk_logits
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

    # 2. build
    t0 = time.perf_counter()
    lib = ta.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 3. kernels against their plain versions
    args, err_eval = check_kernel(EVAL, 0)
    eval_times = time_kernel(EVAL, args)
    train_args, _ = check_kernel(TRAIN, 1)
    time_kernel(TRAIN, train_args)
    del args, train_args
    for i, shape in enumerate(RAGGED):
        check_kernel(shape, 2 + i)
    reference_check()

    # 4. main path through the CLI, launch counts read around it
    torch.cuda.reset_peak_memory_stats()
    ta.tct_attention.launches = 0
    t0 = time.perf_counter()
    summary = cli_test.main(MAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ta.tct_attention.launches
    n_chunks = math.ceil(N_TASKS / 8)
    log(f"[main] tct_attention launches={launches} over {n_chunks} chunks")
    if launches != 2 * n_chunks:
        raise AssertionError(f"expected {2 * n_chunks} kernel launches, got {launches}")
    if summary["n_tasks"] != N_TASKS or not (
            math.isfinite(summary["accuracy"]) and math.isfinite(summary["confidence"])):
        raise AssertionError(f"bad eval summary {summary}")
    log(f"[main] CLI eval on {card}: {N_TASKS / wall:.3f} episodes/s end to end "
        f"({wall:.2f} s, synthetic data drawn on the host included)")
    _, cfg = cli_test.parse(MAIN_ARGV)
    model, batch = one_chunk_check(cfg, torch.device("cuda"))
    device_rate(model, batch, card)

    print(json.dumps({"kernels": [dict(
        name="tct_attention", route="cuda",
        source="litemkd_torch/csrc/tct_attention.cu",
        replaces="litemkd_tpu/ops/pallas_tct.py:61", launches=launches,
        max_abs_err=err_eval, **eval_times)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

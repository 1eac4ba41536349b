#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (litemkd_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing falls back to the CPU):
1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the port from ``litemkd_torch/csrc/``,
   one nvcc process per source, all at once;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the main paths' shapes and at ragged ones, a second launch bitwise
   equal to the first, and time the kernel, the plain version and one
   library call computing the same function, beside the bound; for the TCT
   kernel also each group size G at both main-path shapes, dk % 4 != 0,
   U = 56 and operands one float off 16-byte alignment (its 4-byte
   copies); the TCT kernel's autograd Function against autograd through
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
   kernels on (2 steps of 4 episodes, one micro-batch each, a 4-episode eval at
   the end) through ``litemkd_torch.cli.train.main``, with the launch
   counts read around it; the checkpoint it wrote through the eval CLI;
   then the device-resident training rate with the BN kernels and with
   cuDNN;
6. MFM teacher: the tiny fp32 teacher on the card against the CPU (forward
   logits, one SGD step, extracted features); then at the full width of
   ``preset("mfm_teacher")`` on a seeded per-modality feature tree written
   under ``.chip_smoke/``: 2 training steps of 4 episodes and an
   4-episode eval through ``litemkd_torch.cli.train_teacher.main`` with
   the launch counts read around it, the checkpoint through
   ``--test_only``, and the whole tree through
   ``litemkd_torch.cli.extract.main``; then the device-resident training
   step, eval chunk and extraction rates, peak memory, and one training
   step under the profiler;
7. real video data: a JPEG frame tree (320×240, 8-10 frames a video) with
   the class and video names of phase 6's tree, written with PIL; the
   full-width student trained from it with the BN kernels (2 steps of 4
   episodes, a 4-episode eval) through ``litemkd_torch.cli.train.main``
   against the fused features phase 6 extracted, with the launch counts
   read around it and the clip decoder that ran (the C++ one where it
   builds, PIL otherwise); its checkpoint through
   ``litemkd_torch.cli.test.main`` over a fixed-episode file of
   ``litemkd_torch.cli.gen_fixed_split``, twice (6 episodes, not the 8 of
   the checkpoint's config, the same batches and accuracies both times),
   and once without it (6 other episodes from the same seed); then the
   host's decode rates on 1, 4 and all cores, the host seconds of one
   16-episode batch and of its pinned copy to the card;
8. the expert and pretrain stages on phase 7's tree, closing the chain
   from frames: resnet50 pretraining (one epoch, batches of 8 clips)
   through ``litemkd_torch.cli.pretrain.main``; full-width ``expert_trx``
   training with the BN kernels and per-block remat (2 steps of 4
   episodes in chunks of 4, a 4-episode eval) through
   ``litemkd_torch.cli.train.main`` against phase 6's fused tree, with the
   launch counts read around it; the whole tree through ``cli.extract
   --mode_extract expert --arch resnet50`` from the pretrain checkpoint;
   phase 6's MFM teacher evaluated through ``--test_only`` with that
   extraction as its ``rgb`` modality; then the device-resident expert
   step with and without remat, on the BN kernels and on cuDNN, with peak
   memory. Phase 3 holds the TCT kernel at the expert shape (E 4, Q 20)
   and the BN kernels at the resnet50 layer widths of one expert chunk;
9. the other experts, DeiT pretraining and the eval extras on the trees
   of phases 6 and 7: full-width ``expert_strm --remat`` (the STRM trunk
   without BN kernels, as in the JAX package) and ``expert_baseline
   --pallas_bn --remat`` training (2 steps of 4 episodes, one chunk each,
   a 4-episode eval) through ``litemkd_torch.cli.train`` with the launch
   counts derived from the modules; DeiT-small pretraining (one epoch)
   through ``litemkd_torch.cli.pretrain --arch deit_small``, its
   checkpoint's layout and ``load_pretrain_init`` on it; phase 6's MFM
   checkpoint through ``litemkd_torch.cli.test --test_model teacher``
   twice (one TCT launch each, the same summary); phase 7's checkpoint
   through ``cli.test --per_task_log`` over its fixed-episode file (one
   record a task in order, their mean the summary's, a confusion matrix
   counting every query once); then the device-resident ``expert_strm``
   and ``expert_baseline`` steps and the DeiT pretrain step with peak
   memory. Phase 3's shapes cover these paths;
10. the rest of the student zoo and the skeleton expert: full-width
   ``student_mobilenet`` (MobileNetV3-large 2-fc, cuDNN BatchNorm) trained
   from phase 7's tree against phase 6's fused tree through
   ``litemkd_torch.cli.train`` (2 steps of 4 episodes, one chunk each, an
   4-episode eval) and its checkpoint through ``litemkd_torch.cli.test``,
   with the launch counts derived from the modules read around each; each
   TRX, OTAM, TRX_multi and CTX head at tiny width on the card against
   the CPU and at full width for one training chunk, launches counted;
   ``preset("expert_skeleton_trx")`` at full width on seeded skeleton
   clips (the tiny expert card-vs-CPU first): two SGD steps and an eval
   chunk with the launches counted, then its device step; the
   device-resident training step and eval chunk of ``student_mobilenet``
   with peak memory (the flagship's are phases 5 and 4's). Phase 3 adds the TCT
   kernel at CTX's shape (E 4, Q 25, U 8), checks it at the zoo's other
   full-width shapes (TRX_multi/TRM's U 56 chunk, the skeleton expert's
   16-episode step) at every group size that fits, and its tiny checks a
   ``student_mobilenet`` train step card-vs-CPU;
11. the fusion-teacher zoo on phase 6's tree: every fusion kind (the 5
   bespoke ones, the 31 composer presets and one ``otam:`` kind) at tiny
   width in fp32 on the card against the CPU (logits, and one SGD step
   for five kinds), with the TCT launches each module calls; TSF at the
   full width of ``preset("mfm_teacher")`` through
   ``litemkd_torch.cli.train_teacher --fusion tsf --score_weights 1 0.5
   0.5 --branch_ckpt rgb=<phase 8's expert_trx run>`` (2 steps of 4
   episodes, a 4-episode eval; the graft checked first) and its
   checkpoint through ``--test_only``; ``ThreeTRXCombination`` through
   ``cli.train_teacher`` and ``cli.extract`` of its run directory;
   ``cli.extract --fusion TwoCombinationTemTroShiftTRX_faithful`` with
   ``--extract_side support`` and ``query``, whose trees must differ; each
   with the launch counts derived from the modules read around it; then
   the device-resident training step and eval chunk of eight kinds that
   cover every branch kind, combiner, post-processor and head (FourStrm
   on 4 modalities), with peak memory and the idle share. Phase 3 adds
   the TCT kernel at the ctx head's 16-episode shape (E 16, Q 25, U 8);
12. serving, on the checkpoints of phases 6 and 7: ``litemkd_torch.cli.
   export`` of phase 7's student (as a student and with ``--teacher``) and
   of phase 6's MFM (``--mfm``) to reference ``.pt`` files, each equal to
   its checkpoint and loaded strictly; ``cli.export --aot --aot_check`` of
   the student to a ``torch.export`` artifact traced on the card (2 TCT op
   nodes) that answers 16 requests drawn from phase 7's tree with 2 kernel
   launches each and the eager student's predictions, with device times,
   requests/s and peak memory of both; ``cli.export --aot --mfm`` of the
   MFM to an extract artifact held against eager extraction on phase 6's
   features, with its videos/s; ``cli.demo --once`` from the artifact and
   from the checkpoint (the same predictions), and ``cli.demo`` serving
   three pages from a subprocess; ``tools.pipeline_bench`` at a small size
   and ``tools.shrink_dataset`` of phase 7's tree.
13. analysis and scale-out: ``litemkd_torch.cli.flops`` of three students
   at full width on the card (params equal to the README's table);
   ``cli.profile --path train --pallas_bn`` and ``--path teacher`` (the
   MFM) on 4-episode batches, with the launch counts derived from the
   modules, whose summaries must name the TCT and both BN kernels;
   ``cli.figures cam`` of a frame of phase 7's tree through phase 8's
   resnet50 pretrain checkpoint (the overlay written, its class the argmax
   of ``backbone_predict``); one 4-episode ``cli.train --mesh_data 1``
   step under ``torch.distributed.run`` on NCCL, whose loss must equal a
   plain run's from the same seed; and the data-parallel step's device
   time at one rank beside the plain step's (16 episodes on the card);
14. the mesh's model axis: the flagship student (its frozen teacher too)
   and the MFM at full width cut by ``shard_model`` at M = 1 over a
   one-rank NCCL group, one 4-episode step each against the unsharded
   models (loss, every gradient), launches counted; with two or more
   cards, ``cli.train_teacher --preset mfm_teacher`` and ``cli.train
   --preset student_fc2sup_dist`` at (data 1, model 2) under
   ``torch.distributed.run`` against one card, each rank's launches and
   the device-resident steps per rank at M = 2 (and 4) beside one card's,
   and with four ``cli.test`` of the checkpoint at (2, 2); with one card
   it says that those runs need 2;
15. micro-batch chunks over some data ranks but not all: the flagship at
   full width (BN kernels, dropout 0) in one data-parallel step of gloo
   ranks that share this card, at world 4 (8 episodes in chunks of 4,
   each over two ranks) and world 2 (6 in chunks of 2, the middle one
   across both), in bf16 as it trains and in fp32 (BN biases +3, remat),
   against a one-process step on the card from the same seed and batch:
   in fp32 the loss and metrics, every parameter and running statistic
   within the multi-card test's bounds; every gradient (and the bf16
   loss) within twice the move of the one-process step's own under a
   reordering of each chunk's episodes; the ranks' students equal; each
   rank's launches against the counts of its pieces of the chunk plan;
   the device ms of each rank's bf16 step beside the one-process step's.
   With two or more cards,
   ``cli.train --mesh_data 2`` (6 episodes in chunks of 2) under
   ``torch.distributed.run`` on NCCL, and with four ``--mesh_data 4``
   (8 in chunks of 4), each rank's launches against its plan and the
   first loss against one process on the ranks' batches concatenated.
It prints a ``kernels`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from litemkd_torch import preset
from litemkd_torch.cli import demo as cli_demo
from litemkd_torch.cli import export as cli_export
from litemkd_torch.cli import extract as cli_extract
from litemkd_torch.cli import gen_fixed_split as cli_gen
from litemkd_torch.cli import pretrain as cli_pretrain
from litemkd_torch.cli import test as cli_test
from litemkd_torch.cli import train as cli_train
from litemkd_torch.cli import train_teacher as cli_teacher
from litemkd_torch.cli.common import build_sampler
from litemkd_torch.data import SyntheticEpisodeSource, VideoStore
from litemkd_torch.distill import merge_logits
from litemkd_torch.ops import _build
from litemkd_torch.ops import batch_norm as bn
from litemkd_torch.ops import tct_attention as ta
from litemkd_torch.ops.distances import support_dk_logits
from litemkd_torch.train import (CheckpointManager, EpisodeBatch,
                                 create_mfm_train_state,
                                 create_train_state, make_mfm_eval_step,
                                 make_mfm_train_step, make_pretrain_step,
                                 make_train_step)
from litemkd_torch.train.loop import to_device
from litemkd_torch.utils.metrics import per_episode_accuracy

FP32_PEAK = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
TF32_PEAK = 494.7e12  # H100 SXM dense TF32 FLOP/s in the tensor cores
HBM_RATE = 3.35e12    # H100 SXM HBM3 bytes/s
EVAL = dict(e=8, q=5, u=28, dk=1152, w=5, s=5)    # main path: 8-episode eval chunk
TRAIN = dict(e=4, q=25, u=28, dk=1152, w=5, s=5)  # training micro-batch of 4
MFM_TRAIN = dict(e=16, q=25, u=28, dk=1152, w=5, s=5)  # MFM step: 16 episodes at once
EXPERT_TRAIN = dict(e=4, q=20, u=28, dk=1152, w=5, s=5)  # expert_trx chunk: qpc 4
CTX_TRAIN = dict(e=4, q=25, u=8, dk=1152, w=5, s=5)  # CTX: single frames, U = 8
# the composer's frame-level ctx head (TwoCTXShuffleTime*): a 16-episode step
CTX_STEP = dict(e=16, q=25, u=8, dk=1152, w=5, s=5)
# serving (phase 12): one request of one episode
SERVE = dict(e=1, q=5, u=28, dk=1152, w=5, s=5)
RAGGED = [dict(e=2, q=3, u=28, dk=100, w=130, s=1),
          dict(e=3, q=11, u=28, dk=100, w=7, s=3),
          dict(e=2, q=3, u=28, dk=97, w=5, s=5),     # dk % 4 != 0: 4-byte copies
          dict(e=1, q=3, u=56, dk=1152, w=5, s=5)]   # U=56 (temp set 3)
# the zoo's full-width shapes that no shape above covers: TRX_multi/TRM's
# temp-set-3 chunk (U 56 at G 2 on 132 SMs) and the skeleton expert's step
# (16 episodes of 4 queries a class, G 4)
ZOO_SHAPES = [dict(e=4, q=25, u=56, dk=1152, w=5, s=5),
              dict(e=16, q=20, u=28, dk=1152, w=5, s=5)]
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
# one expert_trx training chunk: 4 episodes × (25 + 20) clips × 8 frames
EXPERT_CHUNK_FRAMES = 1440
BN_RAGGED = [(210, 16), (1000, 100), (4096, 2048)]
TRAIN_EPISODES, TRAIN_STEPS, EVAL_TASKS = 16, 2, 4
# the CLI runs' steps: one micro-batch chunk of 4 episodes each (the device
# rates run TRAIN_EPISODES), so host batch assembly stays a few seconds
CLI_EPISODES = 4
TRAIN_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
              "--pallas_bn", "--tasks_per_batch", str(CLI_EPISODES),
              "--training_iterations",
              str(CLI_EPISODES * TRAIN_STEPS), "--test_iters",
              str(CLI_EPISODES * TRAIN_STEPS), "--num_test_tasks",
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


def device_ms(fn, iters=20, attempts=3):
    """Device time of one ``fn()``: the summed durations of the device
    activities (kernels, copies) that torch.profiler records over ``iters``
    calls, divided by ``iters``. Unlike ``cuda_ms`` it leaves out the gaps
    in which the card waits for the host to launch. On the card's machine
    the profiler has returned no device activity for a window of ~2 ms
    that others before it recorded, so an empty window is profiled again,
    up to ``attempts`` times, before this raises."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            return sum(e.time_range.end - e.time_range.start for e in dev) / 1e3 / iters
        log(f"[profile] torch.profiler recorded no device activity (attempt "
            f"{attempt} of {attempts})")
    raise RuntimeError("torch.profiler recorded no device activity")


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
    """Least time for the fp32-accurate function on this card: the inputs
    read once and the output written once against the two products in
    split TF32 (three TF32 products each) on the tensor cores. Also returns
    the earlier bound, the products in fp32 outside the tensor cores."""
    e, q, u, dk, w, s = (shape[k] for k in ("e", "q", "u", "dk", "w", "s"))
    flops = 4 * e * w * (q * u) * (s * u) * dk        # two products, 2 flop per FMA
    nbytes = 4 * (2 * e * q * u * dk + 2 * e * w * s * u * dk + e * q * w)
    t_ops, t_bytes = 3 * flops / TF32_PEAK, nbytes / HBM_RATE
    fp32_ms = 1e3 * max(flops / FP32_PEAK, t_bytes)
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", fp32_ms)


def tct_launch(args, group):
    """The kernel at the wrapper's group size, or at ``group`` through the
    private launch (both count a launch)."""
    return ta.tct_attention(*args) if group is None else ta._launch(*args, group=group)


def check_kernel(shape, seed, group=None, args=None):
    """The kernel against its plain version within 1e-4·max|plain|, and a
    second launch bitwise equal to the first."""
    args = tct_inputs(shape, seed) if args is None else args
    got = tct_launch(args, group)
    again = tct_launch(args, group)
    torch.cuda.synchronize()
    want = ta.tct_attention_plain(*args)
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    log(f"[kernel] tct_attention {shape} G={group or 'auto'}: max_abs_err={err:.3e} "
        f"tol={tol:.3e}")
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"tct_attention disagrees with its plain version "
                             f"at {shape}, G={group}: {err} > {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"tct_attention is not deterministic at {shape}")
    return args, err


def time_kernel(shape, args):
    """The kernel, the plain version and the library call at one shape:
    CUDA-event times of back-to-back calls (the numbers of the kernels
    line, as in earlier runs) and device times (``device_ms``, without the
    host's launch gaps), beside both bounds."""
    fns = dict(kernel=lambda: ta.tct_attention(*args),
               plain=lambda: ta.tct_attention_plain(*args),
               library=lambda: tct_library(*args))
    events = {k: cuda_ms(f, 20) for k, f in fns.items()}
    device = {k: device_ms(f) for k, f in fns.items()}
    lib_err = (tct_library(*args) - ta.tct_attention_plain(*args)).abs().max().item()
    bound_ms, bound_by, fp32_ms = tct_bound(shape)
    for label, t in (("CUDA events", events), ("device time", device)):
        log(f"[kernel] tct_attention {shape} {label}: kernel_ms={t['kernel']:.4f} "
            f"plain_ms={t['plain']:.4f} library_ms={t['library']:.4f}; "
            f"bound_ms={bound_ms:.4f} ({bound_by}, split TF32; kernel at "
            f"{100 * bound_ms / t['kernel']:.1f}% of it) fp32_bound_ms={fp32_ms:.4f} "
            f"(kernel at {100 * fp32_ms / t['kernel']:.1f}% of it)")
    log(f"[kernel] tct_attention {shape}: library_max_abs_err={lib_err:.3e}")
    return dict(ms=events["kernel"], plain_ms=events["plain"],
                library_ms=events["library"], bound_ms=bound_ms, bound_by=bound_by)


def tct_phase():
    """The TCT kernel at the main paths' shapes (checked, deterministic,
    timed), the group-size sweep there, the ragged shapes, and misaligned
    operands. Returns the eval shape's error and the times at each
    shape."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for name, shape, seed in (("eval", EVAL, 0), ("train", TRAIN, 1),
                              ("mfm_train", MFM_TRAIN, 3),
                              ("expert_train", EXPERT_TRAIN, 4),
                              ("ctx_train", CTX_TRAIN, 7),
                              ("ctx_step", CTX_STEP, 10),
                              ("serve", SERVE, 11)):
        args, err = check_kernel(shape, seed)
        times[name] = time_kernel(shape, args)
        auto = ta.group_size(shape["e"], shape["q"], shape["w"], n_sm)
        sweep = []
        for g in ta.GROUPS:
            check_kernel(shape, seed, group=g, args=args)
            sweep.append(f"G={g} {device_ms(lambda: tct_launch(args, g)):.4f} ms")
        log(f"[kernel] tct_attention {name} group sweep, device time ({n_sm} SMs, "
            f"wrapper picks G={auto}): " + ", ".join(sweep))
        if name == "eval":
            err_eval = err
            shifted = []
            for a in args:     # one float into a larger buffer: not 16-byte aligned
                buf = torch.empty(a.numel() + 1, device="cuda")
                shifted.append(buf[1:].view(a.shape).copy_(a))
            check_kernel(shape, seed, args=shifted)
            log(f"[kernel] tct_attention eval, operands misaligned by one float "
                f"(4-byte copies): device kernel_ms="
                f"{device_ms(lambda: ta.tct_attention(*shifted)):.4f}")
            del shifted
        del args
    for i, shape in enumerate(RAGGED):
        check_kernel(shape, 2 + i)
    lib = ta._library()
    for i, shape in enumerate(ZOO_SHAPES):
        args, _ = check_kernel(shape, 8 + i)
        for g in ta.GROUPS:     # each group size whose score tile fits
            if lib.tct_attention_smem_bytes(shape["s"], shape["u"], g):
                check_kernel(shape, 8 + i, group=g, args=args)
        del args
    return err_eval, times


# Variants of csrc/tct_attention.cu, each a list of (text, replacement) edits
# of its source: the split with lo rounded to nearest as well (what
# cvt.rna.tf32.f32 on both parts gives), and two that give wrong results on
# purpose to show where the time goes (only the hi·hi product of the
# three; no split arithmetic).
_LO = "  lo = __float_as_uint(x - __uint_as_float(hi));"
_SPLIT = "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n" + _LO
TCT_VARIANTS = {
    "kernel": [],
    "lo_rounded": [(_LO, "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u)"
                         " & 0xffffe000u;")],
    "hi_hi_only": [(f"for (int j = 0; j < TN; ++j) mma_tf32(acc[j], {a}, {b}[j][0], {b}[j][1]);",
                    "for (int j = 0; j < TN; ++j) {}") for a, b in (("al", "bh"), ("ah", "bl"))],
    "no_split": [(_SPLIT, "  hi = lo = __float_as_uint(x);")],
}


def tct_variants(out_dir=Path(__file__).resolve().parent / "litemkd_torch" / "_build"):
    """Build every TCT_VARIANTS entry (one nvcc each, in parallel) and print
    the device time of each at both main-path shapes, twice in turns, with
    its largest error relative to max|plain|. Not part of main()."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor
    base = (_build.CSRC / "tct_attention.cu").read_text()

    def build(item):
        name, edits = item
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        cu, so = out_dir / f"variant_{name}.cu", out_dir / f"variant_{name}.so"
        out_dir.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.tct_attention_forward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        return name, lib

    with ThreadPoolExecutor(len(TCT_VARIANTS)) as pool:
        libs = dict(pool.map(build, TCT_VARIANTS.items()))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for label, shape in (("eval", EVAL), ("train", TRAIN)):
        args = tct_inputs(shape, 0)
        e, q, u, dk, w, s = (shape[k] for k in ("e", "q", "u", "dk", "w", "s"))
        g = ta.group_size(e, q, w, n_sm)
        want = ta.tct_attention_plain(*args)
        stream = torch.cuda.current_stream().cuda_stream
        row = []
        for _ in range(2):
            for name, lib in libs.items():
                out = torch.empty(e, q, w, device="cuda")
                ms = device_ms(lambda: lib.tct_attention_forward(
                    *(a.data_ptr() for a in args), out.data_ptr(), e, q, w, s, u, dk,
                    g, 1, stream))
                rel = ((out - want).abs().max() / want.abs().max()).item()
                row.append(f"{name}={ms:.4f} ms (rel err {rel:.1e})")
        log(f"[variants] tct_attention {label} G={g}, device time: " + ", ".join(row))


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


def resnet50_bn_layers(img=224):
    """The BatchNorm inputs of the port's resnet50 trunk at ``img`` px, read
    from the module (a meta-device forward with a hook on every
    BatchNorm): [(name, count, H, W, C)] in order of first use."""
    from litemkd_torch.models.backbones import ResNetTrunk
    from litemkd_torch.ops.batch_norm import BatchNorm
    with torch.device("meta"):
        trunk = ResNetTrunk(50).eval()
        shapes = []
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: shapes.append(tuple(args[0].shape[1:])))
            for m in trunk.modules() if isinstance(m, BatchNorm)]
        trunk(torch.empty(1, img, img, 3))
    for h in hooks:
        h.remove()
    counts = {}
    for c, h, w in shapes:
        counts[(h, w, c)] = counts.get((h, w, c), 0) + 1
    return [(f"{h}x{w}x{c}", n, h, w, c) for (h, w, c), n in counts.items()]


def bn_phase(layers=BN_LAYERS, frames=CHUNK_FRAMES, label="training chunk",
             ragged=True):
    """Every BN shape of a training chunk (``layers``, ``frames`` frames)
    in bf16, timed, and with ``ragged`` the ragged shapes in fp32 and bf16.
    Returns per-chunk totals (each layer's time × its BatchNorms per chunk)
    and the largest error."""
    totals = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
              for k in ("sums", "bwd_sums")}
    err_max = 0.0
    for i, (name, count, h, w, c) in enumerate(layers):
        inputs, err = check_bn(frames * h * w, c, torch.bfloat16, 10 + i)
        err_max = max(err_max, err)
        times = time_bn(name, h, w, c, inputs)
        del inputs
        for key, t in times.items():
            for k in totals[key]:
                totals[key][k] += count * t[k]
            totals[key]["bound_by"] = t["bound_by"]
        torch.cuda.empty_cache()
    if ragged:
        for i, (r, c) in enumerate(BN_RAGGED):
            for dtype in (torch.float32, torch.bfloat16):
                check_bn(r, c, dtype, 20 + i)
    n_bn = sum(layer[1] for layer in layers)
    for key, t in totals.items():
        log(f"[kernel] bn_{key} per {label} ({n_bn} BatchNorms, {frames} "
            f"frames): kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"(kernel at {100 * t['bound_ms'] / t['ms']:.1f}% of the bound)")
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


def _bn_bias_3(model):
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.bias.fill_(3.0)


def train_reference_check(label="tiny fp32 train step", set_bn_bias=_bn_bias_3,
                          cpu_dtype="float32", mean_by_spread=False, **model):
    """One train step of the tiny preset in fp32 (with ``model`` overrides;
    by default the BN kernels on), dropout 0 and the teacher, on the card
    against the same weights and batch on the CPU, there in ``cpu_dtype``.
    ``set_bn_bias`` moves the BN biases so that no pre-activation sits at
    an activation's kink (there a last-bit difference flips a mask): +3
    before a ReLU. Tolerances: metrics 1e-4 relative; gradients
    1e-3·max|g| over all parameters; running statistics 1e-4·max, with
    ``mean_by_spread`` a running mean's max at least the momentum times
    the channel's largest running standard deviation (a batch mean of
    centred activations is a difference of large sums, so its rounding
    error scales with their spread, not with the mean); updated parameters
    the learning rate times the gradients' tolerance, + 1e-6·max|p|."""
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, **{"compute_dtype": "float32", "pallas_bn": True,
                       "trans_dropout": 0.0, **model}))
    ref = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype=cpu_dtype))
    batch = build_sampler(cfg).sample_batch(np.random.default_rng(0),
                                            cfg.train.tasks_per_batch)
    cpu = create_train_state(ref, "cpu")
    with torch.no_grad():
        set_bn_bias(cpu.model)
    gpu = create_train_state(cfg, "cuda", student_state_dict=cpu.model.state_dict(),
                             teacher_state_dict=cpu.teacher.state_dict())
    m_cpu = make_train_step(ref)(cpu, to_device(batch, torch.device("cpu")))
    m_gpu = make_train_step(cfg)(gpu, to_device(batch, torch.device("cuda")))
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
            scale = b.abs().max().item()
            if mean_by_spread and n.endswith("running_mean"):
                bn_mod = cpu.model.get_submodule(n.rsplit(".", 1)[0])
                var = cpu.model.get_buffer(n[:-len("mean")] + "var")
                scale = max(scale, bn_mod.momentum * var.max().item() ** 0.5)
            if not err <= 1e-4 * scale:
                raise AssertionError(f"running statistic {n}: {err}")
            s_err = max(s_err, err / scale)
    log(f"[reference] {label}, cuda vs cpu: metrics "
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


def _timed(cls, name, total):
    """Wrap ``cls.name`` so that its seconds add up in ``total[0]``; returns
    the original."""
    orig = getattr(cls, name)

    def timed(self, *a, **k):
        t = time.perf_counter()
        out = orig(self, *a, **k)
        total[0] += time.perf_counter() - t
        return out

    setattr(cls, name, timed)
    return orig


def _train_records(ckdir):
    """The metric records (those with a step) of the JSONL logs in
    ``ckdir``."""
    records = [json.loads(line) for f in ckdir.glob("*.jsonl")
               for line in f.read_text().splitlines()]
    return [r for r in records if "step" in r]


def train_main_path(card, run_root):
    """Full-width training through the CLI with the launch counts read
    around it; then the checkpoint it wrote through the eval CLI."""
    ckdir = run_root / "run"
    draw = [0.0]
    sample_batch = _timed(SyntheticEpisodeSource, "sample_batch", draw)
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
    chunks = TRAIN_STEPS * CLI_EPISODES // (cfg.train.micro_batch or CLI_EPISODES)
    eval_chunks = math.ceil(EVAL_TASKS / 8)
    want = dict(tct_attention=3 * chunks + 2 * eval_chunks, bn_sums=20 * chunks,
                bn_bwd_sums=20 * chunks)
    log(f"[train] launches {counts} over {chunks} training chunks and "
        f"{eval_chunks} eval chunk(s); expected {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad mid-training eval {history}")
    log("[train] per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "soft_loss", "hard_loss",
                            "accuracy")} for r in steps]))
    n_eps = TRAIN_STEPS * CLI_EPISODES
    log(f"[train] CLI training on {card}: {n_eps / wall:.3f} episodes/s end to "
        f"end ({wall:.2f} s for {n_eps} training + {EVAL_TASKS} eval episodes; "
        f"host synthetic draws {draw[0]:.2f} s on the prefetch thread, beside "
        f"the steps); peak memory "
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
    kernels that take the most device time; returns the idle share. Prints
    "not measured" (and returns None) where the profiler records no device
    activity."""
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
    return 1 - busy / span


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


# ---------------------------------------------------------------------------
# MFM fusion teacher
# ---------------------------------------------------------------------------

MFM_MODS = ("rgb", "depth", "flow")
MFM_CLASSES, MFM_TRAIN_VIDS, MFM_TEST_VIDS = 10, 12, 8
MFM_NOISE = 4.0       # around unit-variance prototypes: accuracy off 100%
MFM_EXTRACT_BATCH = 64


def mfm_reference_check():
    """The tiny MFM teacher in fp32, dropout 0, on the card against the
    same weights and synthetic episodes on the CPU: forward logits, one SGD
    step (metrics 1e-4 relative, gradients 1e-3·max|g|, updated parameters
    1e-4·max|p|) and extracted features, each within 1e-4·max."""
    base = preset("tiny")
    cfg = base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0))
    batch = cli_teacher.SyntheticMultiModalSource(cfg, seed=1).sample_batch(
        np.random.default_rng(0), cfg.train.tasks_per_batch)
    cpu = create_mfm_train_state(cfg, "cpu")
    gpu = create_mfm_train_state(cfg, "cuda",
                                 state_dict=copy.deepcopy(cpu.model.state_dict()))
    errs = {}
    outs = {}
    for state, dev in ((cpu, "cpu"), (gpu, "cuda")):
        b = to_device(batch, torch.device(dev))
        with torch.inference_mode():
            model = state.model.eval()
            outs[dev] = (model(b.support_clips, b.support_labels,
                               b.query_clips)["logits"].cpu(),
                         model.extract(b.query_clips).cpu())
    for i, name in enumerate(("logits", "features")):
        want, got = outs["cpu"][i], outs["cuda"][i]
        errs[name] = (got - want).abs().max().item()
        if not errs[name] <= 1e-4 * want.abs().max().item():
            raise AssertionError(f"tiny MFM {name}, cuda vs cpu: {errs[name]}")
    step = make_mfm_train_step(cfg)
    m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
    m_gpu = step(gpu, to_device(batch, torch.device("cuda")))
    torch.cuda.synchronize()
    for k, v in m_cpu.items():
        if not abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6:
            raise AssertionError(f"MFM train step metric {k}: cuda "
                                 f"{m_gpu[k].item()} vs cpu {v.item()}")
    gp = dict(gpu.model.named_parameters())
    grads = {n: p.grad for n, p in cpu.model.named_parameters() if p.grad is not None}
    g_max = max(g.abs().max().item() for g in grads.values())
    errs["grads"] = max(_max_err(gp[n].grad, g) for n, g in grads.items())
    if not errs["grads"] <= 1e-3 * g_max:
        raise AssertionError(f"MFM gradients: {errs['grads']} > 1e-3 * {g_max}")
    p_max = max(p.abs().max().item() for p in cpu.model.parameters())
    errs["params"] = max(_max_err(gp[n], p) for n, p in cpu.model.named_parameters())
    if not errs["params"] <= 1e-4 * p_max:
        raise AssertionError(f"MFM updated parameters: {errs['params']}")
    log("[reference] tiny fp32 MFM teacher, cuda vs cpu: max_abs_err "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (max|g|={g_max:.3e}, max|p|={p_max:.3e}); metrics "
        + ", ".join(f"{k}={m_gpu[k].item():.6g}/{v.item():.6g}"
                    for k, v in m_cpu.items()))


def write_feature_tree(root, seq_len, dim, seed=0):
    """Per-modality feature trees ``root/<modality>/<class>/<video>/
    feature.npy`` (fp32, seq_len × dim) with split lists under
    ``root/splits``: every video is its class's prototype plus noise; the
    depth file of one video is left out (it zero-fills). Returns the number
    of videos."""
    rng = np.random.default_rng(seed)
    train, test = [], []
    for c in range(MFM_CLASSES):
        cname = f"class{c:02d}"
        protos = rng.standard_normal((len(MFM_MODS), seq_len, dim), np.float32)
        for v in range(MFM_TRAIN_VIDS + MFM_TEST_VIDS):
            vname = f"video_{c:02d}_{v:02d}"
            noise = rng.standard_normal((len(MFM_MODS), seq_len, dim), np.float32)
            for i, m in enumerate(MFM_MODS):
                if (c, v, m) == (0, 0, "depth"):
                    continue
                d = root / m / cname / vname
                d.mkdir(parents=True)
                np.save(d / "feature.npy", protos[i] + MFM_NOISE * noise[i])
            (train if v < MFM_TRAIN_VIDS else test).append(f"{cname}/{vname}")
    (root / "splits").mkdir()
    (root / "splits" / "trainlist03.txt").write_text("\n".join(train) + "\n")
    (root / "splits" / "testlist03.txt").write_text("\n".join(test) + "\n")
    return len(train) + len(test)


def mfm_main_path(card, run_root):
    """Full-width MFM training, its checkpoint through ``--test_only`` and
    the whole tree through extraction, each through its CLI with the
    launch counts read just around it. Returns the training run's
    counts."""
    cfg = preset("mfm_teacher")
    ep, dim = cfg.episode, cfg.model.trans_linear_in_dim
    root, ckdir, out = run_root / "tree", run_root / "mfm", run_root / "fused"
    t0 = time.perf_counter()
    n_videos = write_feature_tree(root, ep.seq_len, dim)
    log(f"[mfm] feature tree: {n_videos} videos x {len(MFM_MODS)} modalities of "
        f"({ep.seq_len}, {dim}) fp32 in {time.perf_counter() - t0:.2f} s")
    data = ["--feature_root", str(root), "--device", "cuda"]
    argv = ["--preset", "mfm_teacher", "--dataset", "hmdb", "--traintestlist",
            str(root / "splits"), "--tasks_per_batch", str(CLI_EPISODES),
            "--training_iterations",
            str(CLI_EPISODES * TRAIN_STEPS), "--test_iters",
            str(CLI_EPISODES * TRAIN_STEPS), "--num_test_tasks", str(EVAL_TASKS),
            "--print_freq", "1", "-c", str(ckdir)] + data
    n_sets = len(cfg.model.temp_set)
    eval_chunks = math.ceil(EVAL_TASKS / 8)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, history = cli_teacher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del state
    want = dict(tct_attention=n_sets * (TRAIN_STEPS + eval_chunks), bn_sums=0,
                bn_bwd_sums=0)
    log(f"[mfm] training launches {counts} over {TRAIN_STEPS} steps of "
        f"{CLI_EPISODES} episodes and {eval_chunks} eval chunk(s); expected {want}")
    if counts != want:
        raise AssertionError(f"MFM launch counts {counts} != {want}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad MFM training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad MFM mid-training eval {history}")
    log("[mfm] per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "accuracy")} for r in steps])
        + f"; eval {history[0]}")
    n_eps = TRAIN_STEPS * CLI_EPISODES
    ckpt = ckdir / f"checkpoint_{n_eps}.pt"
    log(f"[mfm] CLI training on {card}: {n_eps / wall:.3f} episodes/s end to end "
        f"({wall:.2f} s for {n_eps} training + {EVAL_TASKS} eval episodes, model "
        f"set-up, feature reads and the {ckpt.stat().st_size / 1e9:.3f} GB "
        f"checkpoint write included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.empty_cache()

    zero_counts()
    summary = cli_teacher.main(["--test_only", "-m", str(ckpt), "--num_test_tasks",
                                str(EVAL_TASKS)] + data)
    test_counts = read_counts()
    if test_counts["tct_attention"] != n_sets * eval_chunks or \
            summary["n_tasks"] != EVAL_TASKS or not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"bad --test_only run: {summary}, {test_counts}")
    log(f"[mfm] {ckpt.name} through --test_only: {summary}; launches {test_counts}")
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    n = cli_extract.main(["--mode_extract", "mfm", "-m", str(ckpt), "--out", str(out),
                          "--batch_size", str(MFM_EXTRACT_BATCH)] + data)
    torch.cuda.synchronize()
    ext_wall = time.perf_counter() - t0
    ext_counts = read_counts()
    files = sorted(out.rglob("feature.npy"))
    if n != n_videos or len(files) != n_videos or ext_counts["tct_attention"] != 0:
        raise AssertionError(f"extraction wrote {n} / {len(files)} of {n_videos} "
                             f"videos with launches {ext_counts}")
    for f in files:
        a = np.load(f)
        if a.shape != (ep.seq_len, dim) or a.dtype != np.float32 or \
                not np.isfinite(a).all():
            raise AssertionError(f"bad fused feature {f}: {a.shape} {a.dtype}")
    log(f"[mfm] extraction through the CLI on {card}: {n} videos in {ext_wall:.2f} s "
        f"({n / ext_wall:.3f} videos/s end to end, model load included); "
        f"launches {ext_counts}")
    torch.cuda.empty_cache()
    return counts


def mfm_device_batch(cfg, e, train, seed=0):
    """An MFM episode batch made on the card: per-modality features and
    shuffled labels with each class ``shot`` (and ``query_per_class``)
    times."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ep = cfg.episode
    s = ep.way * ep.shot
    q = ep.way * (ep.query_per_class if train else ep.query_per_class_test)

    def labels(n):
        return torch.stack([torch.randperm(n, generator=g, device="cuda") % ep.way
                            for _ in range(e)])

    def feats(n):
        return {m: torch.randn((e, n, ep.seq_len, cfg.model.trans_linear_in_dim),
                               generator=g, device="cuda")
                for m in cfg.model.modalities}

    return EpisodeBatch(feats(s), labels(s), feats(q), labels(q))


def mfm_forward_flops(model, n_videos, seq_len, with_head=True):
    """Operations of one forward over ``n_videos`` videos of ``seq_len``
    frames, 2 per
    multiply-add of the linear layers: every frame token through
    ``three_fusion`` once and the pair ``fusion`` once per modality after
    the first; with the head, every frame tuple through each TCT's
    ``k_linear`` and ``v_linear``. The attention products over 8 frames and
    the TCT kernel add well under 1% and are left out."""
    def macs(module):
        return sum(p.numel() for n, p in module.named_parameters()
                   if p.dim() == 2 and "position_embeddings" not in n)

    tokens = n_videos * seq_len
    fusion = tokens * (macs(model.three_fusion)
                       + (len(model.modalities) - 1) * macs(model.fusion))
    head = n_videos * sum(t.tuples.shape[0] * (t.k_linear.weight.numel()
                                               + t.v_linear.weight.numel())
                          for t in model.bracnch.transformers)
    return 2 * (fusion + (head if with_head else 0))


def mfm_device_rate(card, run_root):
    """Steady-state rates at the full width of ``preset("mfm_teacher")``
    with the data already on the card: a 16-episode training step (CUDA
    events over 3 steps after one warm-up) with its peak memory, an
    8-episode eval chunk, and extraction of a batch of videos; then one
    training step under the profiler. Also the host-clock seconds of the
    CLI's fixed costs: the train state's set-up (random weights drawn on
    the host, then moved to the card) and one checkpoint write."""
    cfg = preset("mfm_teacher")
    t0 = time.perf_counter()
    state = create_mfm_train_state(cfg, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    CheckpointManager(str(run_root / "ckpt")).save(state)
    save_s = time.perf_counter() - t0
    shutil.rmtree(run_root / "ckpt")
    log(f"[mfm] fixed costs on {card}: train state set-up {setup_s:.2f} s, "
        f"checkpoint write {save_s:.2f} s")
    batch = mfm_device_batch(cfg, TRAIN_EPISODES, True)
    step = make_mfm_train_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
    ep, t = cfg.episode, cfg.episode.seq_len
    flops = 3 * mfm_forward_flops(state.model, TRAIN_EPISODES * ep.way
                                  * (ep.shot + ep.query_per_class), t)
    log(f"[mfm] device-resident training on {card}: {1e3 * TRAIN_EPISODES / ms:.3f} "
        f"episodes/s ({ms:.3f} ms per {TRAIN_EPISODES}-episode step; "
        f"{flops / 1e12:.2f} TFLOP in its linear layers, forward and backward, at "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {100 * flops / ms / 1e-3 / FP32_PEAK:.1f}% "
        f"of the fp32 peak); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_step(lambda: step(state, batch), "MFM training step")
    del batch
    model = state.model.eval()
    eval_batch = mfm_device_batch(cfg, 8, False, seed=1)
    eval_step = make_mfm_eval_step(cfg)
    eval_ms = cuda_ms(lambda: eval_step(model, eval_batch), 5, warmup=1)
    flops = mfm_forward_flops(model, 8 * ep.way * (ep.shot + ep.query_per_class_test), t)
    log(f"[mfm] device-resident eval on {card}: {8e3 / eval_ms:.3f} episodes/s "
        f"({eval_ms:.3f} ms per 8-episode chunk; {flops / eval_ms / 1e9:.2f} TFLOP/s "
        f"in the linear layers)")
    g = torch.Generator(device="cuda").manual_seed(2)
    videos = {m: torch.randn((MFM_EXTRACT_BATCH, cfg.episode.seq_len,
                              cfg.model.trans_linear_in_dim), generator=g, device="cuda")
              for m in cfg.model.modalities}
    with torch.inference_mode():
        ext_ms = cuda_ms(lambda: model.extract(videos), 5, warmup=1)
    flops = mfm_forward_flops(model, MFM_EXTRACT_BATCH, t, with_head=False)
    log(f"[mfm] device-resident extraction on {card}: "
        f"{1e3 * MFM_EXTRACT_BATCH / ext_ms:.3f} videos/s ({ext_ms:.3f} ms per "
        f"{MFM_EXTRACT_BATCH} videos; {flops / ext_ms / 1e9:.2f} TFLOP/s in the "
        f"linear layers)")
    del state, model, eval_batch, videos
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Real video data: the student trained from a JPEG frame tree
# ---------------------------------------------------------------------------

FRAME_SIZE = (320, 240)   # HMDB's frames (W, H): the shorter-side resize to 256 works
JPEG_QUALITY = 90
VIDEO_PRESET = "student_fc2sup_dist"
REPLAY_TASKS = 6   # not the checkpoint's num_test_tasks: n_tasks shows the file was read
HOST_EPISODES = 8  # the host's batch assembly timed at each thread count
VIDEO_ARGV = ["--preset", VIDEO_PRESET, "--pallas_bn", "--dataset", "hmdb",
              "--training_iterations", str(CLI_EPISODES * TRAIN_STEPS),
              "--test_iters", str(CLI_EPISODES * TRAIN_STEPS), "--num_test_tasks",
              str(EVAL_TASKS), "--print_freq", "1", "--device", "cuda",
              "--tasks_per_batch", str(CLI_EPISODES)]


def batch_digest(batch):
    """A digest of every array of an EpisodeBatch."""
    h = hashlib.blake2b(digest_size=16)
    for x in batch:
        if x is not None:
            h.update(np.ascontiguousarray(x).view(np.uint8))
    return h.hexdigest()


def _write_video(vdir, pattern, n_frames, seed):
    """``n_frames`` JPEGs of the class ``pattern`` plus seeded noise."""
    rng = np.random.default_rng(seed)
    vdir.mkdir(parents=True)
    for f in range(n_frames):
        frame = pattern + rng.normal(0.0, 12.0, pattern.shape)
        Image.fromarray(np.clip(frame, 0, 255).astype(np.uint8)).save(
            vdir / f"{f:05d}.jpg", quality=JPEG_QUALITY)


def write_jpeg_tree(root, like, seed=0):
    """A frame tree ``root/<class>/<video>/<frame>.jpg`` with the class and
    video names of the tree ``like``: 8, 9 or 10 frames a video of 320×240
    at JPEG quality 90, each class a smooth seeded colour pattern (an 8×6
    grid resized bilinearly) plus noise, so that decoded clips differ by
    class. Written by a thread pool; returns (videos, frames, bytes)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for c, cdir in enumerate(sorted(p for p in like.iterdir() if p.is_dir())):
        grid = rng.uniform(30, 225, (6, 8, 3)).astype(np.uint8)
        pattern = np.asarray(Image.fromarray(grid).resize(FRAME_SIZE, Image.BILINEAR),
                             np.float32)
        for v, vdir in enumerate(sorted(p for p in cdir.iterdir() if p.is_dir())):
            jobs.append((root / cdir.name / vdir.name, pattern, 8 + v % 3,
                         (seed, c, v)))
    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(lambda j: _write_video(*j), jobs))
    files = list(root.rglob("*.jpg"))
    return len(jobs), len(files), sum(f.stat().st_size for f in files)


def host_decode_rates(frames, splits, label):
    """Clips and frames per second of ``VideoStore.load`` (training
    augmentation, 8 frames of 224 px) with the C++ decoder (where it is
    built) and with PIL, on 1, 4 and ``os.cpu_count()`` threads."""
    from litemkd_torch import native
    decoders = ([True] if native.available() else []) + [False]
    for use_native in decoders:
        store = VideoStore(str(frames), str(splits), 3, 8, 224, use_native=use_native)
        recs = [r for c in store.split(True).classes()
                for r in store.split(True).videos_for_class(c)]
        for workers in sorted({1, 4, os.cpu_count()}):
            n = 24 * workers
            jobs = [(recs[i % len(recs)], i) for i in range(n)]
            with ThreadPoolExecutor(max_workers=workers) as pool:
                t0 = time.perf_counter()
                clips = list(pool.map(lambda j: store.load(
                    j[0], True, np.random.default_rng(j[1])), jobs))
                dt = time.perf_counter() - t0
            n_frames = sum(c.shape[0] for c in clips)
            log(f"[video] host decode, {'C++' if use_native else 'PIL'}, {workers} "
                f"thread(s) of os.cpu_count()={os.cpu_count()}: {n / dt:.3f} clips/s, "
                f"{n_frames / dt:.3f} frames/s ({n} clips of 8 frames, 320x240 JPEG "
                f"→ 224 px, in {dt:.3f} s); host of {label}")


def video_main_path(label, run_root):
    """Full-width student training from a JPEG tree through ``cli.train``
    against the fused features phase 6 extracted, with the launch counts
    read around it and the decoder that ran; its checkpoint through
    ``cli.test`` over a ``cli.gen_fixed_split`` file twice (the file's
    count, the same batches and accuracies) and without it (other
    episodes); then the host's decode rates, the host seconds of a
    16-episode batch and its pinned copy to the card. Returns the training
    run's launch counts."""
    from litemkd_torch import native
    from litemkd_torch.data import EpisodeSampler
    from litemkd_torch.data import video as video_mod
    frames, fused, splits = run_root / "frames", run_root / "fused", run_root / "tree" / "splits"
    ckdir, fixed = run_root / "video_run", run_root / "fixed_test.json"
    t0 = time.perf_counter()
    n_videos, n_frames, n_bytes = write_jpeg_tree(frames, fused)
    log(f"[video] JPEG tree: {n_videos} videos, {n_frames} frames of "
        f"{FRAME_SIZE[0]}x{FRAME_SIZE[1]} at quality {JPEG_QUALITY}, "
        f"{n_bytes / 1e6:.1f} MB, written in {time.perf_counter() - t0:.2f} s")
    built = native.available()
    log(f"[video] C++ clip decoder {'built' if built else 'not built on this machine'}"
        f"; {'it' if built else 'PIL'} decodes the clips")
    data = ["--rgb_path", str(frames), "--traintestlist", str(splits)]
    draw = [0.0]
    sample_batch = _timed(EpisodeSampler, "sample_batch", draw)
    video_mod.decoders_used.clear()
    try:
        zero_counts()
        t0 = time.perf_counter()
        _, history = cli_train.main(VIDEO_ARGV + data + ["--teacher_path", str(fused),
                                                         "-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        EpisodeSampler.sample_batch = sample_batch
    cfg = cli_train.parse(VIDEO_ARGV + data)[1]
    chunks = TRAIN_STEPS * CLI_EPISODES // cfg.train.micro_batch
    want = dict(tct_attention=3 * chunks + 2 * math.ceil(EVAL_TASKS / 8),
                bn_sums=20 * chunks, bn_bwd_sums=20 * chunks)
    ran = sorted(video_mod.decoders_used)
    log(f"[video] training launches {counts}, expected {want}; decoder that ran: {ran}")
    if counts != want:
        raise AssertionError(f"real-data launch counts {counts} != {want}")
    if ran != ["native" if built else "pil"]:
        raise AssertionError(f"decoders {ran} ran; the C++ decoder is "
                             f"{'built' if built else 'not built'}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad real-data training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad real-data mid-training eval {history}")
    log("[video] per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "soft_loss", "hard_loss", "accuracy")}
         for r in steps]) + f"; eval {history[0]}")
    n_eps = TRAIN_STEPS * CLI_EPISODES
    log(f"[video] CLI training from the JPEG tree on {label}: {n_eps / wall:.3f} "
        f"episodes/s end to end ({wall:.2f} s for {n_eps} training + {EVAL_TASKS} "
        f"eval episodes, model set-up and checkpoint write included; host batch "
        f"assembly {draw[0]:.2f} s on the prefetch thread, "
        f"{cfg.data.num_workers} decode threads)")

    cli_gen.main(["--preset", VIDEO_PRESET, "--dataset", "hmdb", "--n_episodes",
                  str(REPLAY_TASKS), "--out", str(fixed)] + data)
    ckpt = ckdir / f"checkpoint_{n_eps}.pt"

    def evaluate(extra):
        """``cli.test`` of the checkpoint; returns its summary and the
        digests of the episode batches it drew."""
        digests = []

        def recorded(self, *a, **k):
            out = sample_batch(self, *a, **k)
            digests.append(batch_digest(out))
            return out

        EpisodeSampler.sample_batch = recorded
        try:
            zero_counts()
            summary = cli_test.main(["-m", str(ckpt), "--device", "cuda"] + data + extra)
        finally:
            EpisodeSampler.sample_batch = sample_batch
        if read_counts()["tct_attention"] != 2 * math.ceil(REPLAY_TASKS / 8):
            raise AssertionError(f"eval launches {read_counts()}")
        return summary, digests

    # the file's episodes twice, then as many episodes drawn from the eval
    # seed: a run that ignored the file would draw those
    replays = [evaluate(["--fixed_episode_file", str(fixed)]) for _ in range(2)]
    drawn = evaluate(["--num_test_tasks", str(REPLAY_TASKS)])
    log(f"[video] {ckpt.name} through the eval CLI over {fixed.name} "
        f"({REPLAY_TASKS} episodes; the checkpoint's num_test_tasks is "
        f"{EVAL_TASKS}) twice, then without the file: {replays + [drawn]}")
    if replays[0] != replays[1] or replays[0][0]["n_tasks"] != REPLAY_TASKS or \
            not math.isfinite(replays[0][0]["accuracy"]):
        raise AssertionError(f"fixed-episode replays differ: {replays}")
    if drawn[1] == replays[0][1]:
        raise AssertionError("the eval without the file drew the file's episodes")
    torch.cuda.empty_cache()

    host_decode_rates(frames, splits, label)
    stores = build_sampler(cli_train.parse(VIDEO_ARGV + data + [
        "--teacher_path", str(fused)])[1])
    for workers in sorted({cfg.data.num_workers, os.cpu_count()}):
        sampler = EpisodeSampler(cfg, stores.videos, stores.features,
                                 num_workers=workers)
        t0 = time.perf_counter()
        batch = sampler.sample_batch(np.random.default_rng(workers), HOST_EPISODES)
        dt = time.perf_counter() - t0
        sampler.pool.shutdown()
        n_frames = sum(x.shape[0] * x.shape[1] * x.shape[2]
                       for x in (batch.support_clips, batch.query_clips))
        log(f"[video] host sample_batch of {HOST_EPISODES} episodes "
            f"({n_frames} frames) on {workers} threads: {dt:.3f} s; host of {label}")
    n_bytes = sum(x.nbytes for x in batch if x is not None)
    for i in range(2):
        t0 = time.perf_counter()
        on_card = to_device(batch, torch.device("cuda"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"[video] pinned copy of one batch to the card ({'first' if i == 0 else 'again'}): "
            f"{n_bytes / 1e6:.1f} MB in {dt:.3f} s ({n_bytes / dt / 1e9:.2f} GB/s); {label}")
        del on_card
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# The expert and pretrain stages: pretraining, expert training, expert
# extraction, and the MFM over the port's own expert features
# ---------------------------------------------------------------------------

EXPERT_PRESET = "expert_trx"
EXPERT_ARGV = ["--preset", EXPERT_PRESET, "--pallas_bn", "--remat", "--dataset", "hmdb",
               "--training_iterations", str(CLI_EPISODES * TRAIN_STEPS),
               "--test_iters", str(CLI_EPISODES * TRAIN_STEPS), "--num_test_tasks",
               str(EVAL_TASKS), "--print_freq", "1", "--device", "cuda",
               "--tasks_per_batch", str(CLI_EPISODES)]
PRETRAIN_ARGV = ["--dataset", "hmdb", "--arch", "resnet50", "--epochs", "1",
                 "--batch_size", "8", "--print_freq", "1", "--device", "cuda"]
EXTRACT_DEVICE_VIDEOS = 64
# (remat, micro-batch): per-block remat at the preset's 4 episodes a chunk,
# and none at 2 (the JAX bench's expert setting); each with the BN kernels
# and with cuDNN BatchNorm
EXPERT_RATE_SETTINGS = [(True, 4, True), (True, 4, False), (False, 2, True),
                        (False, 2, False)]


def student_tct_calls(cfg):
    """TCT kernel launches of one forward of ``cfg``'s student: the calls
    of the kernel's wrapper (:func:`tct_wrapper_calls`) on a CPU copy with
    the same backbone, head and widths at the tiny episode geometry (32
    px)."""
    from litemkd_torch.models import BatchedStudent
    tiny = preset("tiny")
    small = tiny.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="float32", pallas_bn=False))
    model = BatchedStudent(small).eval()
    batch = SyntheticEpisodeSource(small, n_classes=8, seed=0,
                                   with_teacher_feats=False).sample_batch(
        np.random.default_rng(0), 1, train=False)
    b = to_device(batch, torch.device("cpu"))
    with torch.inference_mode():
        return tct_wrapper_calls(lambda: model(b.support_clips, b.support_labels,
                                               b.query_clips))


def chunk_launches(cfg):
    """The launches of one training chunk (or piece of one) of ``cfg``'s
    student: its TCT calls and the frozen teacher's one, one ``bn_sums``
    per BN-kernel BatchNorm of the trunk plus one per such BatchNorm of a
    residual block recomputed under remat, one ``bn_bwd_sums`` each."""
    from litemkd_torch.models import BatchedStudent
    from litemkd_torch.ops.batch_norm import BatchNorm
    with torch.device("meta"):
        trunk = BatchedStudent(cfg).backbone.resnet
    n_bn = sum(isinstance(m, BatchNorm) and m.pallas_bn for m in trunk.modules())
    n_block = sum(isinstance(m, BatchNorm) and m.pallas_bn
                  for layer in list(trunk)[4:] for m in layer.modules())
    return dict(tct_attention=student_tct_calls(cfg) + 1,
                bn_sums=n_bn + (n_block if cfg.model.remat else 0),
                bn_bwd_sums=n_bn)


def expert_launches(cfg):
    """The kernel launches of ``cli.train`` for ``cfg`` (2 steps and an
    ``EVAL_TASKS``-episode eval, with a teacher tree): per training chunk
    :func:`chunk_launches`; the eval chunks launch the student's TCT calls
    only. BatchNorms without ``pallas_bn`` (the STRM trunk's, as in the
    JAX package) launch nothing."""
    per = chunk_launches(cfg)
    chunks = TRAIN_STEPS * CLI_EPISODES // cfg.train.micro_batch
    out = {k: v * chunks for k, v in per.items()}
    out["tct_attention"] += (per["tct_attention"] - 1) * math.ceil(EVAL_TASKS / 8)
    return out


def pretrain_path(label, frames, splits, ckdir):
    """Full-width resnet50 pretraining through ``cli.pretrain``: one epoch
    over the tree's training videos, then the test split; no kernel of the
    port runs (the classifier has cuDNN BatchNorm, as in the JAX package).
    Returns the checkpoint it kept."""
    loads = [0.0]
    orig = _timed(VideoStore, "load", loads)
    try:
        zero_counts()
        t0 = time.perf_counter()
        state = cli_pretrain.main(PRETRAIN_ARGV + [
            "--rgb_path", str(frames), "--traintestlist", str(splits), "-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        VideoStore.load = orig
    if counts != dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0):
        raise AssertionError(f"pretraining launched kernels: {counts}")
    epochs = [r for r in _train_records(ckdir) if "epoch_loss" in r]
    if len(epochs) != 1 or not all(math.isfinite(v) for v in epochs[0].values()):
        raise AssertionError(f"bad pretraining metrics {epochs}")
    saved = sorted(ckdir.glob("checkpoint_*.pt"))
    if len(saved) != 1 or saved[0].name != f"checkpoint_{state.episodes_seen}.pt":
        raise AssertionError(f"pretraining kept {saved}")
    vs = VideoStore(str(frames), str(splits), 3, 8, 224)
    n_train = state.episodes_seen
    n_test = sum(vs.split(False).n_videos(c) for c in vs.split(False).classes())
    log(f"[pretrain] resnet50 through cli.pretrain on {label}: {state.step} steps of "
        f"8 clips, epoch metrics {epochs[0]}; {(n_train + n_test) / wall:.3f} clips/s "
        f"end to end ({n_train} training + {n_test} test clips of 8 frames at 224 "
        f"px in {wall:.2f} s, model set-up and the {saved[0].stat().st_size / 1e6:.1f} "
        f"MB checkpoint write included; host clip loads {loads[0]:.2f} s, the "
        f"training batches' on the prefetch thread); kept {saved[0].name}")
    return saved[0]


def expert_train_path(label, frames, splits, fused, ckdir, argv=None):
    """Full-width expert training (``argv``: by default ``expert_trx`` with
    the BN kernels and per-block remat; 2 steps of 4 episodes in chunks of
    4, a 4-episode eval) through ``cli.train`` against the fused tree,
    with the launch counts read around it. Returns the counts."""
    from litemkd_torch.data import EpisodeSampler
    argv = argv or EXPERT_ARGV
    name = argv[argv.index("--preset") + 1]
    data = ["--rgb_path", str(frames), "--traintestlist", str(splits),
            "--teacher_path", str(fused)]
    draw = [0.0]
    orig = _timed(EpisodeSampler, "sample_batch", draw)
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        t0 = time.perf_counter()
        _, history = cli_train.main(argv + data + ["-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        EpisodeSampler.sample_batch = orig
    want = expert_launches(cli_train.parse(argv + data)[1])
    log(f"[expert] {name} training launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"{name} launch counts {counts} != {want}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad {name} training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad {name} mid-training eval {history}")
    n_eps = TRAIN_STEPS * CLI_EPISODES
    log(f"[expert] {name} per-step metrics: " + json.dumps(
        [{k: r[k] for k in r if k not in ("time", "episodes")} for r in steps])
        + f"; eval {history[0]}")
    flags = " ".join(a for a in argv if a in ("--pallas_bn", "--remat"))
    log(f"[expert] {name} {flags} through cli.train from the JPEG tree "
        f"on {label}: {n_eps / wall:.3f} episodes/s end to end ({wall:.2f} s for "
        f"{n_eps} training + {EVAL_TASKS} eval episodes, model set-up and checkpoint "
        f"write included; host batch assembly {draw[0]:.2f} s on the prefetch "
        f"thread); peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    return counts


def expert_extract_path(label, frames, splits, pretrained, out):
    """The whole tree through ``cli.extract --mode_extract expert --arch
    resnet50 -m <pretrain checkpoint>``: every file (8, 2048) fp32 finite,
    no kernel launched; then the device-resident rate per
    ``EXTRACT_DEVICE_VIDEOS`` videos."""
    argv = ["--mode_extract", "expert", "--arch", "resnet50", "-m", str(pretrained),
            "--dataset", "hmdb", "--rgb_path", str(frames), "--traintestlist",
            str(splits), "--out", str(out), "--device", "cuda"]
    zero_counts()
    t0 = time.perf_counter()
    n = cli_extract.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    files = sorted(out.rglob("feature.npy"))
    if n != len(files) or n == 0 or any(counts.values()):
        raise AssertionError(f"expert extraction wrote {n} / {len(files)} files, "
                             f"launches {counts}")
    for f in files:
        a = np.load(f)
        if a.shape != (8, 2048) or a.dtype != np.float32 or not np.isfinite(a).all():
            raise AssertionError(f"bad expert feature {f}: {a.shape} {a.dtype}")
    log(f"[expert] extraction through cli.extract on {label}: {n} videos in "
        f"{wall:.2f} s ({n / wall:.3f} videos/s end to end, trunk load and host "
        f"decode included)")
    _, args, cfg = cli_extract.parse(argv)
    model = cli_extract.load_expert_trunk(cfg, "resnet50", str(pretrained),
                                          torch.device("cuda"))
    clips = torch.randint(0, 256, (EXTRACT_DEVICE_VIDEOS, 8, 224, 224, 3),
                          dtype=torch.uint8, device="cuda")

    def run():
        with torch.inference_mode():
            return model.expert_features(clips)

    ms = cuda_ms(run, 5, warmup=1)
    log(f"[expert] device-resident extraction on {label}: "
        f"{1e3 * EXTRACT_DEVICE_VIDEOS / ms:.3f} videos/s ({ms:.3f} ms per "
        f"{EXTRACT_DEVICE_VIDEOS} videos of 8 frames at 224 px, bf16 trunk)")
    del model, clips
    torch.cuda.empty_cache()
    return n


def chain_eval(label, run_root, expert_out):
    """The MFM teacher of phase 6 evaluated through ``cli.train_teacher
    --test_only`` on a feature root whose ``rgb`` tree is the port's own
    expert extraction (``depth`` and ``flow`` as phase 6 wrote them): one
    TCT launch, a finite accuracy."""
    chain = run_root / "chain"
    chain.mkdir()
    (chain / "rgb").symlink_to(expert_out)
    for m in MFM_MODS[1:]:
        (chain / m).symlink_to(run_root / "tree" / m)
    ckpt = run_root / "mfm" / f"checkpoint_{CLI_EPISODES * TRAIN_STEPS}.pt"
    zero_counts()
    summary = cli_teacher.main(["--test_only", "-m", str(ckpt), "--num_test_tasks",
                                str(EVAL_TASKS), "--feature_root", str(chain),
                                "--device", "cuda"])
    counts = read_counts()
    if counts != dict(tct_attention=1, bn_sums=0, bn_bwd_sums=0) or \
            summary["n_tasks"] != EVAL_TASKS or not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"bad MFM eval over the port's expert features: "
                             f"{summary}, {counts}")
    log(f"[chain] MFM --test_only over rgb features from the port's resnet50 "
        f"expert extraction (depth, flow from phase 6) on {label}: {summary}; "
        f"launches {counts}")
    return counts


def expert_device_rate(label, name=EXPERT_PRESET, settings=EXPERT_RATE_SETTINGS,
                       profile=True):
    """The training step of preset ``name`` on one 16-episode batch made on
    the card (CUDA events over 3 steps after one warm-up) with peak memory,
    for each (remat, micro-batch, BN kernels) of ``settings``; then, with
    ``profile``, one step of the first under the profiler."""
    for remat, micro, pallas_bn in settings:
        base = preset(name)
        cfg = base.replace(
            model=dataclasses.replace(base.model, pallas_bn=pallas_bn, remat=remat),
            train=dataclasses.replace(base.train, micro_batch=micro))
        state = create_train_state(cfg, "cuda")
        batch = device_batch(cfg, TRAIN_EPISODES)
        step = make_train_step(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
        what = (f"{'remat' if remat else 'no remat'}, micro-batch {micro}, "
                f"{'BN kernels' if pallas_bn else 'cuDNN BatchNorm'}")
        ep = cfg.episode
        frames = micro * ep.way * (ep.shot + ep.query_per_class) * ep.seq_len
        log(f"[expert] device-resident {name} training on {label}, {what}: "
            f"{1e3 * TRAIN_EPISODES / ms:.3f} episodes/s ({ms:.3f} ms per "
            f"{TRAIN_EPISODES}-episode step of {TRAIN_EPISODES // micro} chunks of "
            f"{frames} frames); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if profile and (remat, micro, pallas_bn) == settings[0]:
            profile_step(lambda: step(state, batch), f"{name} step, {what}")
        del state, batch
        torch.cuda.empty_cache()


def expert_main_path(label, run_root):
    """Phase 8 on phase 7's JPEG tree: pretraining, expert training, expert
    extraction and the chain's MFM eval, each through its CLI. Returns the
    summed launch counts of expert training and the chain's eval."""
    frames, splits = run_root / "frames", run_root / "tree" / "splits"
    pretrained = pretrain_path(label, frames, splits, run_root / "pretrain")
    counts = expert_train_path(label, frames, splits, run_root / "fused",
                               run_root / "expert")
    n = expert_extract_path(label, frames, splits, pretrained, run_root / "rgb_expert")
    chain = chain_eval(label, run_root, run_root / "rgb_expert")
    log(f"[expert] {n} videos: pretrained, expert-trained and extracted from frames")
    return {k: counts[k] + chain[k] for k in counts}


# ---------------------------------------------------------------------------
# The STRM and Baseline experts, DeiT pretraining and the eval extras
# ---------------------------------------------------------------------------

STRM_ARGV = ["--preset", "expert_strm", "--remat"] + EXPERT_ARGV[4:]
BASELINE_ARGV = ["--preset", "expert_baseline", "--pallas_bn", "--remat"] + EXPERT_ARGV[4:]
DEIT_ARGV = ["--dataset", "hmdb", "--arch", "deit_small", "--epochs", "1",
             "--batch_size", "8", "--print_freq", "1", "--device", "cuda"]


def deit_pretrain_path(label, frames, splits, ckdir):
    """Full-width DeiT-small pretraining through ``cli.pretrain --arch
    deit_small`` (one epoch, batches of 8 clips; no kernel of the port
    runs), then its checkpoint's layout (timm's names under ``convnet.``,
    and ``fc``) and ``load_pretrain_init(ckpt, "deit_small")`` on it."""
    from litemkd_torch.tools.weights import load_pretrain_init
    loads = [0.0]
    orig = _timed(VideoStore, "load", loads)
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        t0 = time.perf_counter()
        state = cli_pretrain.main(DEIT_ARGV + [
            "--rgb_path", str(frames), "--traintestlist", str(splits), "-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        VideoStore.load = orig
    if any(counts.values()):
        raise AssertionError(f"deit pretraining launched kernels: {counts}")
    epochs = [r for r in _train_records(ckdir) if "epoch_loss" in r]
    if len(epochs) != 1 or not all(math.isfinite(v) for v in epochs[0].values()):
        raise AssertionError(f"bad deit pretraining metrics {epochs}")
    saved = sorted(ckdir.glob("checkpoint_*.pt"))
    if len(saved) != 1:
        raise AssertionError(f"deit pretraining kept {saved}")
    sd = torch.load(saved[0], map_location="cpu", weights_only=True)["model_state_dict"]
    block = {f"convnet.blocks.{i}.{m}.{w}" for i in range(12) for m in (
        "norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2")
        for w in ("weight", "bias")}
    layout = block | {"convnet.cls_token", "convnet.dist_token", "convnet.pos_embed",
                      "convnet.patch_embed.proj.weight", "convnet.patch_embed.proj.bias",
                      "convnet.norm.weight", "convnet.norm.bias", "fc.weight", "fc.bias"}
    if set(sd) != layout or tuple(sd["convnet.blocks.0.attn.qkv.weight"].shape) != (1152, 384):
        raise AssertionError(f"deit checkpoint layout: {sorted(set(sd) ^ layout)[:8]}")
    part = load_pretrain_init(str(saved[0]), "deit_small")
    if set(part) != layout - {"fc.weight", "fc.bias"} or not all(
            torch.equal(part[k], sd[k]) for k in part):
        raise AssertionError("load_pretrain_init did not read the deit trunk back")
    vs = VideoStore(str(frames), str(splits), 3, 8, 224)
    n_train = state.episodes_seen
    n_test = sum(vs.split(False).n_videos(c) for c in vs.split(False).classes())
    log(f"[deit] deit_small through cli.pretrain on {label}: {state.step} steps of 8 "
        f"clips, epoch metrics {epochs[0]}; {(n_train + n_test) / wall:.3f} clips/s "
        f"end to end ({n_train} training + {n_test} test clips of 8 frames at 224 px "
        f"in {wall:.2f} s, model set-up and the {saved[0].stat().st_size / 1e6:.1f} MB "
        f"checkpoint write included; host clip loads {loads[0]:.2f} s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {saved[0].name} holds "
        f"{len(sd)} convnet./fc. keys and load_pretrain_init reads its trunk back")
    model = state.model.eval()
    clips = torch.randint(0, 256, (8, 8, 224, 224, 3), dtype=torch.uint8, device="cuda")
    labels = torch.randint(0, model.fc.out_features, (8,), device="cuda")
    step = make_pretrain_step(cli_pretrain.parse(DEIT_ARGV + [
        "--rgb_path", str(frames), "--traintestlist", str(splits)])[2])
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, clips, labels), 5, warmup=1)
    log(f"[deit] device-resident deit_small pretrain step on {label}: "
        f"{8e3 / ms:.3f} clips/s ({ms:.3f} ms per step of 8 clips of 8 frames at "
        f"224 px, bf16 autocast); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del state, model, clips
    torch.cuda.empty_cache()


def teacher_eval_path(label, run_root):
    """``cli.test --test_model teacher`` of phase 6's MFM checkpoint (its
    ``bracnch.transformers.0`` head) over phase 6's fused tree, the
    sampler decoding phase 7's clips too: one TCT launch per eval chunk,
    and a second run gives the same accuracy and CI. Returns the launch
    counts of the first run."""
    from litemkd_torch.data import EpisodeSampler
    ckpt = run_root / "mfm" / f"checkpoint_{CLI_EPISODES * TRAIN_STEPS}.pt"
    argv = ["--test_model", "teacher", "-m", str(ckpt), "--dataset", "hmdb",
            "--rgb_path", str(run_root / "frames"), "--teacher_path",
            str(run_root / "fused"), "--traintestlist", str(run_root / "tree" / "splits"),
            "--num_test_tasks", str(EVAL_TASKS), "--device", "cuda"]
    runs = []
    for _ in range(2):
        draw = [0.0]
        orig = _timed(EpisodeSampler, "sample_batch", draw)
        try:
            zero_counts()
            t0 = time.perf_counter()
            summary = cli_test.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            EpisodeSampler.sample_batch = orig
        runs.append((summary, read_counts(), wall, draw[0]))
    want = dict(tct_attention=math.ceil(EVAL_TASKS / 8), bn_sums=0, bn_bwd_sums=0)
    (s1, c1, wall, draw), (s2, c2, _, _) = runs
    log(f"[teacher] cli.test --test_model teacher of {ckpt.name} over the fused tree "
        f"on {label}: {s1}, then {s2}; launches {c1} and {c2}, expected {want}; "
        f"{EVAL_TASKS / wall:.3f} episodes/s end to end ({wall:.2f} s, host batch "
        f"assembly {draw:.2f} s with the clips)")
    if c1 != want or c2 != want:
        raise AssertionError(f"teacher eval launches {c1}, {c2} != {want}")
    if s1 != s2 or s1["n_tasks"] != EVAL_TASKS or not math.isfinite(s1["accuracy"]):
        raise AssertionError(f"teacher eval runs differ: {s1} vs {s2}")
    return c1


def per_task_log_path(label, run_root):
    """``cli.test --per_task_log`` of phase 7's student checkpoint over its
    fixed-episode file: one record per task in task order, whose mean
    accuracy is the summary's, and a confusion matrix that counts every
    query once. Returns the launch counts."""
    from litemkd_torch.tools.confusion import (confusion_from_records,
                                               most_confused, read_task_log)
    ckpt = run_root / "video_run" / f"checkpoint_{CLI_EPISODES * TRAIN_STEPS}.pt"
    path = run_root / "tasks.jsonl"
    zero_counts()
    summary = cli_test.main([
        "-m", str(ckpt), "--fixed_episode_file", str(run_root / "fixed_test.json"),
        "--per_task_log", str(path), "--rgb_path", str(run_root / "frames"),
        "--traintestlist", str(run_root / "tree" / "splits"), "--device", "cuda"])
    counts = read_counts()
    records = read_task_log(str(path))
    m, ids = confusion_from_records(records)
    cfg = cli_test.parse(["-m", str(ckpt)])[1]
    n_queries = REPLAY_TASKS * cfg.episode.way * cfg.episode.query_per_class_test
    mean = 100.0 * float(np.mean([r["accuracy"] for r in records]))
    log(f"[tasks] cli.test --per_task_log of {ckpt.name} over the fixed file on "
        f"{label}: {summary}; {len(records)} records, mean accuracy {mean:.6f}; "
        f"confusion matrix {m.shape} over {int(m.sum())} queries, trace "
        f"{int(np.trace(m))}, most confused {most_confused(m, ids, top=3)}; "
        f"launches {counts}")
    if [r["task"] for r in records] != list(range(REPLAY_TASKS)):
        raise AssertionError(f"per-task records out of order: {[r['task'] for r in records]}")
    if abs(mean - summary["accuracy"]) > 1e-6 or int(m.sum()) != n_queries:
        raise AssertionError(f"per-task log disagrees: mean {mean} vs {summary}, "
                             f"{int(m.sum())} of {n_queries} queries")
    if counts != dict(tct_attention=2 * math.ceil(REPLAY_TASKS / 8), bn_sums=0,
                      bn_bwd_sums=0):
        raise AssertionError(f"per-task eval launches {counts}")
    return counts


def zoo_main_path(label, run_root):
    """Phase 9 on phase 7's JPEG tree and phase 6's trees: ``expert_strm``
    and ``expert_baseline --pallas_bn`` training, DeiT-small pretraining,
    the teacher eval and a per-task log, each through its CLI, then the
    device-resident expert steps. Returns the summed launch counts."""
    frames, splits, fused = run_root / "frames", run_root / "tree" / "splits", run_root / "fused"
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)
    for counts in (
            expert_train_path(label, frames, splits, fused, run_root / "strm", STRM_ARGV),
            expert_train_path(label, frames, splits, fused, run_root / "baseline",
                              BASELINE_ARGV),
            teacher_eval_path(label, run_root),
            per_task_log_path(label, run_root)):
        total = {k: total[k] + counts[k] for k in total}
    deit_pretrain_path(label, frames, splits, run_root / "deit")
    expert_device_rate(label, "expert_strm", [(True, 4, False)], profile=False)
    expert_device_rate(label, "expert_baseline", [(True, 4, True)], profile=False)
    return total


# ---------------------------------------------------------------------------
# The rest of the student zoo and the skeleton expert
# ---------------------------------------------------------------------------

MOBILE_ARGV = ["--preset", "student_mobilenet"] + VIDEO_ARGV[3:]
ZOO_HEADS = ["TRX_sup", "TRX_sup_fixed", "TRX_2fc", "TRX_1fc_sup", "TRX_2fcsup_2",
             "TRX_2fcsup_2_fixed", "OTAM", "CNN_OTAM", "TRX_multi", "TRM", "CTX",
             "CTX_videoaxis"]
TWO_STREAM_HEADS = {"TRX_2fc", "TRX_2fcsup_2"}
ZOO_TEMP_SET = (2, 3)    # TRX_multi/TRM: two TCT sets, U = 28 and 56


def _mobilenet_bn_bias(model):
    """+3 on a BatchNorm before a ReLU, 0 elsewhere (hard-swish bends at
    ±3, three standard deviations from a zero-bias BatchNorm's output)."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.bias.zero_()
        if isinstance(m, torch.nn.Sequential) and len(m) == 3 and \
                isinstance(m[1], torch.nn.BatchNorm2d) and m[2].fn is F.relu:
            m[1].bias.fill_(3.0)


def tct_wrapper_calls(fn):
    """Calls of the TCT kernel's wrapper during ``fn()`` (run on the CPU,
    where the wrapper takes the plain version): what the same modules
    launch on the card."""
    from litemkd_torch.ops import tct as tct_mod
    real, calls = tct_mod.tct_attention, [0]

    def counted(*a):
        calls[0] += 1
        return real(*a)

    tct_mod.tct_attention = counted
    try:
        fn()
    finally:
        tct_mod.tct_attention = real
    return calls[0]


def _head_inputs(name, e, s, q, t, d, way, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    streams = ("f1", "f2") if name in TWO_STREAM_HEADS else (None,)

    def feats(n):
        out = {k: torch.randn((e, n, t, d), generator=g, device=device)
               for k in streams}
        return out[None] if streams == (None,) else out

    labels = torch.stack([torch.randperm(s, generator=g, device=device) % way
                          for _ in range(e)])
    return feats(s), labels, feats(q)


def _logits(out):
    return out if isinstance(out, dict) else {"logits": out}


def zoo_heads_check(label):
    """Each head of this slice: at tiny width in fp32 on the card against
    the same weights and features on the CPU (1e-4·max per output), with
    the TCT launches on the card equal to the wrapper's calls on the CPU;
    then at full width (D 2048, dk 1152, 5-way 5-shot, 5 queries a class,
    8 frames, 4 episodes) for one training chunk, forward and backward,
    finite outputs and gradients, the launches again as the modules call
    them. Returns the summed launches of the full-width chunks."""
    from litemkd_torch.models import init_student_, make_classifier
    total, rows = 0, []
    for name in ZOO_HEADS:
        base = preset("tiny")
        cfg = base.replace(model=dataclasses.replace(
            base.model, compute_dtype="float32", trans_dropout=0.0,
            temp_set=ZOO_TEMP_SET))
        ep = cfg.episode
        cpu = make_classifier(name, cfg).eval()
        init_student_(cpu, torch.Generator().manual_seed(1))
        gpu = copy.deepcopy(cpu).to("cuda")
        args = _head_inputs(name, 2, ep.way * ep.shot, ep.way * ep.query_per_class,
                            ep.seq_len, cfg.model.trans_linear_in_dim, ep.way,
                            "cpu", 2)
        with torch.no_grad():
            calls = tct_wrapper_calls(lambda: cpu(*args))
            want = _logits(cpu(*args))
            zero_counts()
            got = _logits(gpu(*(to_device_any(a, "cuda") for a in args)))
            torch.cuda.synchronize()
            launched = read_counts()["tct_attention"]
        err = max(_max_err(got[k], want[k]) / max(want[k].abs().max().item(), 1e-30)
                  for k in want)
        if launched != calls or not err <= 1e-4 or got.keys() != want.keys():
            raise AssertionError(f"{name} on the card: relative error {err}, "
                                 f"launches {launched} (the CPU calls {calls})")
        full = preset("student_fc2sup_dist")
        fcfg = full.replace(model=dataclasses.replace(
            full.model, classifier=name, temp_set=ZOO_TEMP_SET))
        fe = fcfg.episode
        head = init_student_(make_classifier(name, fcfg),
                             torch.Generator().manual_seed(4)).to("cuda").train()
        fargs = _head_inputs(name, TRAIN["e"], fe.way * fe.shot,
                             fe.way * fe.query_per_class, fe.seq_len,
                             fcfg.model.trans_linear_in_dim, fe.way, "cuda", 3)
        for a in fargs:
            for x in (a.values() if isinstance(a, dict) else [a]):
                x.requires_grad_(x.is_floating_point())
        zero_counts()
        out = _logits(head(*fargs))
        sum(v.float().sum() for v in out.values()).backward()
        torch.cuda.synchronize()
        n = read_counts()["tct_attention"]
        grads = [p.grad for p in head.parameters() if p.grad is not None]
        grads += [x.grad for a in (fargs[0], fargs[2])
                  for x in (a.values() if isinstance(a, dict) else [a])]
        if n != calls or not all(torch.isfinite(v).all() for v in out.values()) or \
                not all(torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"{name} at full width: launches {n} (the "
                                 f"modules call {calls}), or non-finite values")
        total += n
        rows.append(f"{name} {n} launch(es), rel err {err:.2e}")
        del head, fargs, out, grads
    torch.cuda.empty_cache()
    log(f"[zoo] heads card vs cpu (tiny fp32) and one full-width training chunk "
        f"each on {label}: " + "; ".join(rows) + f"; {total} launches at full width")
    return total


def to_device_any(x, device):
    if isinstance(x, dict):
        return {k: v.to(device) for k, v in x.items()}
    return x.to(device)


def skeleton_batch(cfg, e, q_per_class, device, seed=0):
    """An episode batch of seeded skeleton clips (J = 17 joints × 3
    coordinates a frame) made on ``device``; no teacher features."""
    g = torch.Generator(device=device).manual_seed(seed)
    ep = cfg.episode
    s, q = ep.way * ep.shot, ep.way * q_per_class

    def labels(n):
        return torch.stack([torch.randperm(n, generator=g, device=device) % ep.way
                            for _ in range(e)])

    def clips(n):
        return torch.randn((e, n, ep.seq_len, 17, 3), generator=g, device=device)

    return EpisodeBatch(clips(s), labels(s), clips(q), labels(q))


def skeleton_expert_path(label):
    """``preset("expert_skeleton_trx")`` at full width (D 2048, 8 frames,
    5-way 5-shot, 4 queries a class, 16 episodes in one fused step, fp32):
    the tiny expert on the card against the CPU (logits 1e-4·max), then two
    SGD steps and one 8-episode eval chunk on seeded skeleton clips on the
    card, the TCT launches counted around them against the modules' calls
    (its batches carry no teacher features, so no teacher runs); then the
    device step's time and peak memory. Returns the launches."""
    from litemkd_torch.models import BatchedStudent, init_student_
    from litemkd_torch.train import make_eval_step
    base = preset("tiny")
    tiny = base.replace(model=dataclasses.replace(
        base.model, backbone="s3d", classifier="TRX", trans_dropout=0.0))
    cpu = BatchedStudent(tiny).eval()
    init_student_(cpu, torch.Generator().manual_seed(4))
    gpu = copy.deepcopy(cpu).to("cuda")
    b = skeleton_batch(tiny, 2, 2, "cpu", 5)
    with torch.no_grad():
        calls = tct_wrapper_calls(lambda: cpu(*b[:3]))
        want = cpu(*b[:3])["logits"]
        got = gpu(*(x.to("cuda") for x in b[:3]))["logits"]
    err = _max_err(got, want) / want.abs().max().item()
    if not err <= 1e-4:
        raise AssertionError(f"tiny skeleton expert on the card: rel err {err}")

    cfg = preset("expert_skeleton_trx")
    ep = cfg.episode
    state = create_train_state(cfg, "cuda", with_teacher=False)
    step = make_train_step(cfg)
    batch = skeleton_batch(cfg, TRAIN_EPISODES, ep.query_per_class, "cuda", 6)
    evalb = skeleton_batch(cfg, 8, ep.query_per_class_test, "cuda", 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    metrics = [step(state, batch) for _ in range(2)]
    acc = make_eval_step(cfg)(state.model.eval(), evalb)
    torch.cuda.synchronize()
    counts = read_counts()
    want_counts = dict(tct_attention=3 * calls, bn_sums=0, bn_bwd_sums=0)
    losses = [m["task_loss"].item() for m in metrics]
    log(f"[skeleton] expert_skeleton_trx on {label}: 2 steps of {TRAIN_EPISODES} "
        f"episodes, task_loss {losses}, eval accuracies {acc.tolist()}; launches "
        f"{counts}, expected {want_counts} ({calls} a forward); tiny card vs cpu "
        f"rel err {err:.2e}")
    if counts != want_counts or not all(math.isfinite(x) for x in losses) or \
            acc.shape != (8,) or not torch.isfinite(acc).all():
        raise AssertionError(f"skeleton expert: launches {counts}, losses {losses}")
    state.model.train()
    ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
    log(f"[skeleton] device-resident expert_skeleton_trx training on {label}: "
        f"{1e3 * TRAIN_EPISODES / ms:.3f} episodes/s ({ms:.3f} ms per "
        f"{TRAIN_EPISODES}-episode step, one fused chunk of "
        f"{TRAIN_EPISODES * ep.way * (ep.shot + ep.query_per_class) * ep.seq_len} "
        f"frames, fp32); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    profile_step(lambda: step(state, batch), "expert_skeleton_trx step")
    del state, batch, evalb
    torch.cuda.empty_cache()
    return counts


def mobilenet_main_path(label, run_root):
    """Full-width ``student_mobilenet`` (MobileNetV3-large 2-fc, cuDNN
    BatchNorm) trained from phase 7's JPEG tree through ``cli.train``
    against phase 6's fused tree (2 steps of 4 episodes, one chunk each, a
    4-episode eval), then its checkpoint through ``cli.test`` (4 episodes),
    with the launch counts read around each: the flagship's TCT launches
    (kl and ce a chunk, the frozen teacher in training), no BN kernel.
    Returns the summed counts."""
    from litemkd_torch.data import EpisodeSampler
    frames, splits, fused = run_root / "frames", run_root / "tree" / "splits", run_root / "fused"
    ckdir = run_root / "mobile"
    data = ["--rgb_path", str(frames), "--traintestlist", str(splits)]
    draw = [0.0]
    orig = _timed(EpisodeSampler, "sample_batch", draw)
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        t0 = time.perf_counter()
        _, history = cli_train.main(MOBILE_ARGV + data + ["--teacher_path", str(fused),
                                                          "-c", str(ckdir)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        EpisodeSampler.sample_batch = orig
    cfg = cli_train.parse(MOBILE_ARGV + data)[1]
    chunks = TRAIN_STEPS * CLI_EPISODES // cfg.train.micro_batch
    calls = student_tct_calls(cfg)
    want = dict(tct_attention=(calls + 1) * chunks + calls * math.ceil(EVAL_TASKS / 8),
                bn_sums=0, bn_bwd_sums=0)
    log(f"[mobile] student_mobilenet training launches {counts}, expected {want} "
        f"({calls} TCT calls a student forward, {chunks} chunks)")
    if counts != want:
        raise AssertionError(f"student_mobilenet launch counts {counts} != {want}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad student_mobilenet training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad student_mobilenet mid-training eval {history}")
    n_eps = TRAIN_STEPS * CLI_EPISODES
    log("[mobile] per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "soft_loss", "hard_loss", "accuracy")}
         for r in steps]) + f"; eval {history[0]}")
    log(f"[mobile] student_mobilenet through cli.train from the JPEG tree on {label}: "
        f"{n_eps / wall:.3f} episodes/s end to end ({wall:.2f} s for {n_eps} training "
        f"+ {EVAL_TASKS} eval episodes, model set-up and checkpoint write included; "
        f"host batch assembly {draw[0]:.2f} s on the prefetch thread); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ckpt = ckdir / f"checkpoint_{n_eps}.pt"
    zero_counts()
    t0 = time.perf_counter()
    summary = cli_test.main(["-m", str(ckpt), "--num_test_tasks", str(EVAL_TASKS),
                             "--device", "cuda"] + data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    test_counts = read_counts()
    want = dict(tct_attention=calls * math.ceil(EVAL_TASKS / 8), bn_sums=0,
                bn_bwd_sums=0)
    log(f"[mobile] {ckpt.name} through cli.test on {label}: {summary}; launches "
        f"{test_counts}, expected {want}; {EVAL_TASKS / wall:.3f} episodes/s end "
        f"to end ({wall:.2f} s)")
    if test_counts != want or summary["n_tasks"] != EVAL_TASKS or \
            not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"bad eval of the student_mobilenet checkpoint: "
                             f"{summary}, {test_counts}")
    torch.cuda.empty_cache()
    return {k: counts[k] + test_counts[k] for k in counts}


def mobilenet_device_rate(label):
    """The device-resident ``student_mobilenet`` training step (16
    episodes, chunks of 4; CUDA events over 3 steps after one warm-up) and
    eval chunk (8 episodes, 1 query a class), with peak memory, then one
    step under the profiler. The resnet18 flagship's, on the same card in
    the same run, are phase 5's cuDNN step and phase 4's eval chunk."""
    from litemkd_torch.cli.test import load_student
    cfg = preset("student_mobilenet")
    state = create_train_state(cfg, "cuda")
    batch = device_batch(cfg, TRAIN_EPISODES)
    step = make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_step(lambda: step(state, batch), "student_mobilenet step")
    del state, batch
    torch.cuda.empty_cache()
    ecfg = cfg.replace(episode=dataclasses.replace(
        cfg.episode, query_per_class=cfg.episode.query_per_class_test))
    model = load_student(ecfg, None, "cuda")
    eb = device_batch(ecfg, 8)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ems = cuda_ms(lambda: model(eb.support_clips, eb.support_labels,
                                    eb.query_clips), 5, warmup=1)
    epeak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[zoo] device-resident student_mobilenet ({cfg.model.backbone}) on "
        f"{label}: training {1e3 * TRAIN_EPISODES / ms:.3f} episodes/s ({ms:.3f} "
        f"ms per {TRAIN_EPISODES}-episode step of "
        f"{TRAIN_EPISODES // cfg.train.micro_batch} chunks, cuDNN BatchNorm), peak "
        f"{peak:.3f} GiB; eval {8e3 / ems:.3f} episodes/s ({ems:.3f} ms per "
        f"8-episode chunk), peak {epeak:.3f} GiB")
    del model, eb
    torch.cuda.empty_cache()


def student_zoo_path(label, run_root):
    """Phase 10: ``student_mobilenet`` through its CLIs on the trees of
    phases 6 and 7, each zoo head on the card, the skeleton expert, and the
    device-resident rates. Returns the summed launch counts of the CLI
    runs, the full-width head chunks and the skeleton expert."""
    counts = mobilenet_main_path(label, run_root)
    counts["tct_attention"] += zoo_heads_check(label)
    skel = skeleton_expert_path(label)
    mobilenet_device_rate(label)
    return {k: counts[k] + skel[k] for k in counts}


# ---------------------------------------------------------------------------
# The fusion-teacher zoo
# ---------------------------------------------------------------------------

FUSION_BESPOKE = ("tsf", "dga", "dga2", "two_road", "two_road_videoaxis")
FUSION_OTAM = "otam:ThreeTRXShiftLoopTime"
# kinds whose tiny SGD step runs on the card against the CPU: a weighted
# score fusion, the two-road head, a cross combiner, batch statistics and pad
# shifts (not DGA2: its enrichment's PE dropout is fixed at 0.1, and the
# card and the CPU draw other masks)
FUSION_STEP_KINDS = ("tsf", "two_road", "ThreeCross", "TwoFusionBatchFusion",
                     "ThreeTRXShuffleTime_faithful")
TSF_WEIGHTS = ("1", "0.5", "0.5")
# at the synthetic source's default noise (0.3), and for TSF still at 1.0,
# the tiny teachers classify every query with near certainty and a step's
# gradients (1e-8 to 1e-5) are rounding; at 2.0 accuracy is 58-83% and the
# largest gradients 0.05-13
FUSION_NOISE = 2.0
# the device-resident steps: together every branch kind (pair, multi, cross,
# self, batch), combiner (sum, cross), post-processor (mlp), head (trx, ctx,
# otam), the bespoke heads and 4 modalities
FUSION_DEVICE_KINDS = ("dga2", "two_road", "ThreeCross", "ThreeFusion3_videoaxis",
                       "TwoCTXShuffleTime", "OTAMThreeTRXShiftLoopTime", "FourStrm",
                       "TwoFusionBatchFusion")
FUSION_MODS = ("rgb", "depth", "flow", "skeleton", "ir")


def fusion_cfg(name, kind, **model):
    """Preset ``name`` with the modalities that ``kind`` indexes: five for
    Five*, four for Four* and ThreeCombinationTRX, else three."""
    k = kind.split(":")[-1]
    n = 5 if k.startswith("Five") else 4 if k.startswith(
        ("Four", "ThreeCombinationTRX")) else 3
    base = preset(name)
    return base.replace(model=dataclasses.replace(
        base.model, modalities=FUSION_MODS[:n], **model))


def _weights(kind):
    return {"score_weights": tuple(map(float, TSF_WEIGHTS))} if kind == "tsf" else {}


def fusion_tct_calls(kind):
    """TCT kernel launches of one forward of ``kind``'s teacher: the calls
    of the kernel's wrapper on a tiny CPU copy (the same heads at any
    width)."""
    from litemkd_torch.train import make_mfm
    cfg = fusion_cfg("tiny", kind, compute_dtype="float32")
    model = make_mfm(cfg, kind, **_weights(kind)).eval()
    b = to_device(cli_teacher.SyntheticMultiModalSource(cfg, seed=0).sample_batch(
        np.random.default_rng(0), 1), torch.device("cpu"))
    with torch.inference_mode():
        return tct_wrapper_calls(lambda: model(b.support_clips, b.support_labels,
                                               b.query_clips))


def fusion_zoo_check(label):
    """Every fusion kind (the 5 bespoke ones, the 31 composer presets and
    one ``otam:`` kind) at tiny width in fp32, dropout 0, on the card
    against the same weights and episodes on the CPU: logits within
    1e-4·max, the TCT launches on the card equal to the wrapper's calls on
    the CPU; for ``FUSION_STEP_KINDS`` also one SGD step (metrics 1e-4
    relative, gradients 1e-3·max|g|). Synthetic features at noise
    ``FUSION_NOISE``."""
    from litemkd_torch.models.teacher import FUSION_PRESETS
    rows = []
    for kind in FUSION_BESPOKE + tuple(FUSION_PRESETS) + (FUSION_OTAM,):
        cfg = fusion_cfg("tiny", kind, compute_dtype="float32", trans_dropout=0.0)
        batch = cli_teacher.SyntheticMultiModalSource(
            cfg, seed=1, noise=FUSION_NOISE).sample_batch(
            np.random.default_rng(0), cfg.train.tasks_per_batch)
        cpu = create_mfm_train_state(cfg, "cpu", kind, **_weights(kind))
        gpu = create_mfm_train_state(cfg, "cuda", kind, **_weights(kind),
                                     state_dict=copy.deepcopy(cpu.model.state_dict()))
        calls = fusion_tct_calls(kind)
        out = {}
        for state, dev in ((cpu, "cpu"), (gpu, "cuda")):
            b = to_device(batch, torch.device(dev))
            zero_counts()
            with torch.inference_mode():
                out[dev] = state.model.eval()(b.support_clips, b.support_labels,
                                              b.query_clips)["logits"].cpu()
            torch.cuda.synchronize()
            if dev == "cuda":
                launched = read_counts()["tct_attention"]
        want = out["cpu"]
        err = _max_err(out["cuda"], want) / want.abs().max().item()
        if not err <= 1e-4 or launched != calls:
            raise AssertionError(f"fusion kind {kind} on the card: relative error "
                                 f"{err}, launches {launched} (the CPU calls {calls})")
        row = f"{kind} {calls} launch(es) rel {err:.1e}"
        if kind in FUSION_STEP_KINDS:
            step = make_mfm_train_step(cfg)
            m_cpu = step(cpu, to_device(batch, torch.device("cpu")))
            m_gpu = step(gpu, to_device(batch, torch.device("cuda")))
            torch.cuda.synchronize()
            for k, v in m_cpu.items():
                if not abs(m_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-6:
                    raise AssertionError(f"{kind} train step metric {k}: cuda "
                                         f"{m_gpu[k].item()} vs cpu {v.item()}")
            gp = dict(gpu.model.named_parameters())
            grads = {n: p.grad for n, p in cpu.model.named_parameters()
                     if p.grad is not None}
            g_max = max(g.abs().max().item() for g in grads.values())
            g_err = max(_max_err(gp[n].grad, g) for n, g in grads.items())
            if not g_err <= 1e-3 * g_max:
                raise AssertionError(f"{kind} gradients: {g_err} > 1e-3 * {g_max}")
            row += (f", step loss {m_gpu['task_loss'].item():.4g}, grads "
                    f"{g_err / g_max:.1e} of max|g|")
        rows.append(row)
        del cpu, gpu
    torch.cuda.empty_cache()
    log(f"[fusion] every kind, tiny fp32, card vs cpu on {label}: " + "; ".join(rows))


def fusion_argv(root, ckdir, kind):
    """``cli.train_teacher`` at the full width of ``preset("mfm_teacher")``
    on phase 6's tree: 2 steps of 4 episodes and a 4-episode eval."""
    return ["--preset", "mfm_teacher", "--dataset", "hmdb", "--feature_root",
            str(root), "--traintestlist", str(root / "splits"),
            "--tasks_per_batch", str(CLI_EPISODES), "--training_iterations",
            str(CLI_EPISODES * TRAIN_STEPS), "--test_iters",
            str(CLI_EPISODES * TRAIN_STEPS), "--num_test_tasks", str(EVAL_TASKS),
            "--print_freq", "1", "-c", str(ckdir), "--fusion", kind,
            "--device", "cuda"]


def fusion_cli_train(label, kind, argv, ckdir):
    """One full-width ``cli.train_teacher`` run with the launch counts read
    around it, against the kind's calls per forward (one forward a step and
    one an eval chunk). Returns the counts and the checkpoint."""
    per_forward = fusion_tct_calls(kind)
    eval_chunks = math.ceil(EVAL_TASKS / 8)
    want = dict(tct_attention=per_forward * (TRAIN_STEPS + eval_chunks),
                bn_sums=0, bn_bwd_sums=0)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    state, history = cli_teacher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del state
    log(f"[fusion] {kind} training launches {counts}, expected {want} "
        f"({per_forward} a forward)")
    if counts != want:
        raise AssertionError(f"{kind} launch counts {counts} != {want}")
    steps = [r for r in _train_records(ckdir) if "task_loss" in r]
    if len(steps) != TRAIN_STEPS or not all(
            math.isfinite(r[k]) for r in steps for k in r):
        raise AssertionError(f"bad {kind} training metrics {steps}")
    if len(history) != 1 or not math.isfinite(history[0]["accuracy"]):
        raise AssertionError(f"bad {kind} mid-training eval {history}")
    n_eps = TRAIN_STEPS * CLI_EPISODES
    log(f"[fusion] {kind} per-step metrics: " + json.dumps(
        [{k: r[k] for k in ("step", "task_loss", "accuracy")} for r in steps])
        + f"; eval {history[0]}")
    log(f"[fusion] {kind} through cli.train_teacher on {label}: "
        f"{n_eps / wall:.3f} episodes/s end to end ({wall:.2f} s for {n_eps} "
        f"training + {EVAL_TASKS} eval episodes, model set-up and checkpoint "
        f"write included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    return counts, ckdir / f"checkpoint_{n_eps}.pt", per_forward


def tsf_main_path(label, run_root):
    """The reference's score-fusion flow over the port's own expert: phase
    8's ``expert_trx`` run directory grafted into the rgb branch (its one
    TCT set checked equal in the branch before training), TSF trained
    through ``cli.train_teacher --fusion tsf --score_weights 1 0.5 0.5
    --branch_ckpt rgb=<run>``, then its checkpoint through
    ``--test_only``. Returns the summed launch counts."""
    from litemkd_torch.train import make_mfm
    from litemkd_torch.train.teacher_steps import load_tsf_branches
    root, expert, ckdir = run_root / "tree", run_root / "expert", run_root / "tsf"
    cfg = preset("mfm_teacher")
    model = make_mfm(cfg, "tsf", **_weights("tsf"))
    load_tsf_branches(model, {"rgb": str(expert)}, cfg.model.temp_set)
    mgr = CheckpointManager(str(expert))
    head = torch.load(mgr.path(mgr.latest_step()), map_location="cpu",
                      weights_only=True)["model_state_dict"]
    for k in ("k_linear.weight", "v_linear.bias", "norm_k.weight"):
        got = model.m1_branch.transformers[0].get_parameter(k)
        if not torch.equal(got.detach(), head[f"classifier.transformers.{k}"]):
            raise AssertionError(f"TSF graft of {expert}: {k} differs")
    del model
    argv = fusion_argv(root, ckdir, "tsf") + ["--score_weights", *TSF_WEIGHTS,
                                             "--branch_ckpt", f"rgb={expert}"]
    counts, ckpt, per_forward = fusion_cli_train(label, "tsf", argv, ckdir)
    zero_counts()
    summary = cli_teacher.main(["--test_only", "-m", str(ckpt), "--fusion", "tsf",
                                "--score_weights", *TSF_WEIGHTS, "--num_test_tasks",
                                str(EVAL_TASKS), "--feature_root", str(root),
                                "--device", "cuda"])
    test_counts = read_counts()
    if test_counts["tct_attention"] != per_forward * math.ceil(EVAL_TASKS / 8) or \
            summary["n_tasks"] != EVAL_TASKS or not math.isfinite(summary["accuracy"]):
        raise AssertionError(f"bad TSF --test_only run: {summary}, {test_counts}")
    log(f"[fusion] tsf {ckpt.name} through --test_only: {summary}; launches "
        f"{test_counts}")
    torch.cuda.empty_cache()
    return {k: counts[k] + test_counts[k] for k in counts}


def fusion_extract(label, what, argv, out, n_videos):
    """``cli.extract --mode_extract mfm`` of the whole tree (``what`` names
    the run in the log): every file (8, 2048) fp32 and finite, no kernel
    launched. Returns the files."""
    zero_counts()
    t0 = time.perf_counter()
    n = cli_extract.main(["--mode_extract", "mfm", "--out", str(out),
                          "--batch_size", str(MFM_EXTRACT_BATCH),
                          "--device", "cuda"] + argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    files = {f.relative_to(out): np.load(f) for f in out.rglob("feature.npy")}
    if n != n_videos or len(files) != n_videos or any(counts.values()):
        raise AssertionError(f"fusion extraction wrote {n} / {len(files)} of "
                             f"{n_videos} videos with launches {counts}")
    for f, a in files.items():
        if a.shape != (8, 2048) or a.dtype != np.float32 or not np.isfinite(a).all():
            raise AssertionError(f"bad fused feature {f}: {a.shape} {a.dtype}")
    log(f"[fusion] extraction of {what} through cli.extract on {label}: {n} videos in {wall:.2f} s ({n / wall:.3f} videos/s end "
        f"to end, model set-up included)")
    return files


def combination_main_path(label, run_root, n_videos):
    """The scripts' ``combination_r+d+f`` model (ThreeTRXCombination)
    through ``cli.train_teacher`` and ``cli.extract`` of its run directory
    (its dump rolls m2 and m3 left, unlike its live fusion); then
    ``cli.extract --fusion TwoCombinationTemTroShiftTRX_faithful`` from a
    fresh init with ``--extract_side support`` and ``query``, whose trees
    must differ in every file (the 3-stream branch is on the support side
    only). Returns the training run's launch counts."""
    root, ckdir = run_root / "tree", run_root / "combination"
    kind = "ThreeTRXCombination"
    counts, _, _ = fusion_cli_train(label, kind, fusion_argv(root, ckdir, kind),
                                    ckdir)
    fusion_extract(label, f"{kind} from its run directory",
                   ["--fusion", kind, "-m", str(ckdir), "--feature_root", str(root)],
                   run_root / "combination_fused", n_videos)
    data = ["--preset", "mfm_teacher", "--dataset", "hmdb", "--feature_root",
            str(root), "--traintestlist", str(root / "splits"), "--fusion",
            "TwoCombinationTemTroShiftTRX_faithful"]
    trees = {side: fusion_extract(label, f"{data[-1]} ({side} side, fresh init)",
                                  data + ["--extract_side", side],
                                  run_root / f"side_{side}", n_videos)
             for side in ("support", "query")}
    same = [f for f in trees["support"]
            if np.allclose(trees["support"][f], trees["query"][f])]
    if trees["support"].keys() != trees["query"].keys() or same:
        raise AssertionError(f"support- and query-side trees agree on {len(same)} "
                             "files")
    log(f"[fusion] TwoCombinationTemTroShiftTRX_faithful: the support- and "
        f"query-side trees differ in all {n_videos} files")
    torch.cuda.empty_cache()
    return counts


def fusion_device_rate(label):
    """For each of ``FUSION_DEVICE_KINDS`` at the full width of
    ``preset("mfm_teacher")`` (FourStrm on a 4-modality batch), with the
    data on the card: the 16-episode training step (CUDA events over 3
    steps after one warm-up) with its TCT launches, peak memory and, from
    one step under the profiler, the device's idle share; then the
    8-episode eval chunk (5 after one warm-up) and its peak memory."""
    for kind in FUSION_DEVICE_KINDS:
        cfg = fusion_cfg("mfm_teacher", kind)
        t0 = time.perf_counter()
        state = create_mfm_train_state(cfg, "cuda", kind)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.model.parameters())
        batch = mfm_device_batch(cfg, TRAIN_EPISODES, True)
        step = make_mfm_train_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        ms = cuda_ms(lambda: step(state, batch), 3, warmup=1)
        launches = read_counts()["tct_attention"] / 4
        peak = torch.cuda.max_memory_allocated() / 2**30
        idle = profile_step(lambda: step(state, batch), f"{kind} training step")
        del batch
        model = state.model.eval()
        eval_batch = mfm_device_batch(cfg, 8, False, seed=1)
        eval_step = make_mfm_eval_step(cfg)
        torch.cuda.reset_peak_memory_stats()
        eval_ms = cuda_ms(lambda: eval_step(model, eval_batch), 5, warmup=1)
        eval_peak = torch.cuda.max_memory_allocated() / 2**30
        idle_s = "not measured" if idle is None else f"{idle:.3f}"
        row = (f"{kind} ({n_params / 1e6:.1f} M parameters, set-up "
               f"{setup_s:.2f} s): step {ms:.3f} ms ({1e3 * TRAIN_EPISODES / ms:.3f} "
               f"episodes/s), {launches:g} TCT launch(es) a step, peak "
               f"{peak:.3f} GiB, idle share {idle_s}; eval {eval_ms:.3f} ms "
               f"per 8-episode chunk ({8e3 / eval_ms:.3f} episodes/s), peak "
               f"{eval_peak:.3f} GiB")
        log(f"[fusion] device-resident on {label}: {row}")
        del state, model, eval_batch
        torch.cuda.empty_cache()


def fusion_zoo_path(label, run_root):
    """Phase 11 on phase 6's tree and phase 8's expert run: every kind card
    vs CPU, TSF with the grafted expert and ThreeTRXCombination through the
    CLIs at full width, and the device-resident steps. Returns the summed
    launch counts of the CLI runs."""
    t0 = time.perf_counter()
    fusion_zoo_check(label)
    tsf = tsf_main_path(label, run_root)
    n_videos = MFM_CLASSES * (MFM_TRAIN_VIDS + MFM_TEST_VIDS)
    combination = combination_main_path(label, run_root, n_videos)
    fusion_device_rate(label)
    log(f"[fusion] phase 11 took {time.perf_counter() - t0:.2f} s")
    return {k: tsf[k] + combination[k] for k in tsf}


# ---------------------------------------------------------------------------
# Serving: reference .pt exports, torch.export artifacts, the demo, and the
# host tools, on the checkpoints and trees of phases 6 and 7
# ---------------------------------------------------------------------------

SERVE_REQUESTS = 16
SERVE_EXTRACT_BATCH = 8


def _export_pt(label, src, out, flags):
    """``cli.export`` of ``src`` to a reference ``.pt`` with ``flags``: no
    kernel launched, ``iteration`` the checkpoint's, every tensor equal to
    the checkpoint's under its exported name."""
    zero_counts()
    t0 = time.perf_counter()
    cli_export.main(["--ckpt", str(src), "--out", str(out), "--device", "cuda"] + flags)
    dt = time.perf_counter() - t0
    if read_counts() != dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0):
        raise AssertionError(f"cli.export {flags} launched {read_counts()}")
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    got = torch.load(out, map_location="cpu", weights_only=True)
    want = ckpt["model_state_dict"]
    if "--teacher" in flags:
        head = "classifier.transformers."
        want = {f"bracnch.transformers.0.{k[len(head):]}": v for k, v in want.items()
                if k.startswith(head)}
    if got["iteration"] != ckpt["iteration"] or set(got["model_state_dict"]) != set(want) \
            or not all(torch.equal(got["model_state_dict"][k], v) for k, v in want.items()):
        raise AssertionError(f"cli.export {flags}: {out.name} differs from {src}")
    log(f"[serve] cli.export {' '.join(flags) or '(student)'} of {src.parent.name}/"
        f"{src.name}: {len(want)} tensors, {out.stat().st_size / 1e6:.1f} MB in "
        f"{dt:.2f} s; equal to the checkpoint's; {label}")
    return got["model_state_dict"]


def _export_aot(argv):
    """``cli.export --aot`` with its stdout captured; returns (stdout,
    seconds of the whole call, the manifest ``cli.export`` returns, which
    holds the seconds of ``torch.export.export`` and ``torch.export.save``)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        manifest = cli_export.main(argv)
    log(buf.getvalue().rstrip())
    return buf.getvalue(), time.perf_counter() - t0, manifest["seconds"]


def _on_card(batch):
    return (torch.from_numpy(batch.support_clips).to("cuda"),
            torch.from_numpy(batch.support_labels).to("cuda", torch.int64),
            torch.from_numpy(batch.query_clips).to("cuda"))


def _serve_requests(name, fn, batches, sample_s):
    """Answer every request with ``fn`` (host arrays in, logits back on the
    host), then time it on batches already on the card; returns the
    logits, with the launch counts of the answering run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits = [fn(*_on_card(b)).float().cpu() for b in batches]
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    on_card = [_on_card(b) for b in batches]
    ms = cuda_ms(lambda: [fn(*b) for b in on_card], 3, warmup=1) / len(batches)
    busy = device_ms(lambda: fn(*on_card[0]), iters=10)
    n = len(batches)
    log(f"[serve] {name}: {ms:.3f} device ms a request (CUDA events, batch on the "
        f"card; device busy {busy:.3f} ms of it by torch.profiler, idle share "
        f"{1 - busy / ms:.3f}); {n / (sample_s + wall):.3f} requests/s end to end ({sample_s:.2f} s "
        f"host sampling + {wall:.2f} s copy, score and read-back for {n} requests); "
        f"peak memory {peak:.3f} GiB")
    del on_card
    return logits, counts


def _demo_server(artifact, log_path):
    """``cli.demo`` serving ``artifact`` on a free port in a subprocess:
    GET /?seed=0..2 must answer 200 with a page that names the accuracy.
    The server is shut down whatever happens."""
    import urllib.request
    repo = Path(__file__).resolve().parent
    with open(log_path, "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "litemkd_torch.cli.demo", "-m",
                                 str(artifact), "--port", "0", "--device", "cuda"],
                                cwd=repo, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            line = [None]
            reader = threading.Thread(target=lambda: line.__setitem__(
                0, proc.stdout.readline()), daemon=True)
            reader.start()
            reader.join(timeout=300)
            if not line[0] or "demo serving on http://127.0.0.1:" not in line[0]:
                raise AssertionError(f"the demo server did not start: {line[0]!r}; "
                                     f"{Path(log_path).read_text()[-2000:]}")
            url = line[0].split()[-1]
            for seed in range(3):
                t0 = time.perf_counter()
                with urllib.request.urlopen(f"{url}/?seed={seed}", timeout=300) as resp:
                    status, body = resp.status, resp.read().decode()
                if status != 200 or f"(seed {seed}) — accuracy" not in body:
                    raise AssertionError(f"GET /?seed={seed}: {status} {body[:300]}")
                acc = body.split("accuracy ")[1].split("<")[0]
                log(f"[serve] demo server {url}/?seed={seed}: {status}, accuracy {acc}, "
                    f"{time.perf_counter() - t0:.3f} s")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"[serve] demo server stopped (exit {proc.returncode})")


def serving_path(label, run_root):
    """Phase 12 on the checkpoints of phases 6 and 7: ``cli.export`` to the
    reference's student, teacher and MFM files; the student's scorer
    artifact (``cli.export --aot --aot_check``) answering requests drawn
    from phase 7's tree against the eager student; the MFM's extract
    artifact against eager extraction; ``cli.demo`` from the artifact and
    the checkpoint, and as a server; ``tools.pipeline_bench`` and
    ``tools.shrink_dataset``. Returns the phase's launch counts."""
    import contextlib
    import io
    from litemkd_torch.cli.common import load_saved_config
    from litemkd_torch.models import BatchedStudent
    from litemkd_torch.tools import aot, pipeline_bench, shrink_dataset
    from litemkd_torch.train import make_mfm
    t_phase = time.perf_counter()
    n_eps = CLI_EPISODES * TRAIN_STEPS
    run, mfm_run = run_root / "video_run", run_root / "mfm"
    ckpt, mfm_ckpt = run / f"checkpoint_{n_eps}.pt", mfm_run / f"checkpoint_{n_eps}.pt"
    out = run_root / "serving"
    out.mkdir()
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)

    def add(counts, want_tct):
        if counts != dict(tct_attention=want_tct, bn_sums=0, bn_bwd_sums=0):
            raise AssertionError(f"launches {counts}, expected {want_tct} TCT and no BN")
        for k in total:
            total[k] += counts[k]

    # (a) reference .pt files, each loaded strictly into a fresh module
    cfg, mcfg = load_saved_config(ckpt), load_saved_config(mfm_ckpt)
    BatchedStudent(cfg).load_state_dict(
        _export_pt(label, ckpt, out / "student.pt", []), strict=True)
    _export_pt(label, ckpt, out / "teacher.pt", ["--teacher"])
    cli_test.load_teacher(cfg, str(out / "teacher.pt"), "cpu")
    with torch.device("meta"):
        make_mfm(mcfg).load_state_dict(
            _export_pt(label, mfm_ckpt, out / "mfm.pt", ["--mfm"]), strict=True,
            assign=True)

    # (b) the student's scorer artifact against the eager student
    artifact = run / "model.litemkd"
    zero_counts()
    printed, export_s, secs = _export_aot(
        ["--ckpt", str(ckpt), "--out", str(artifact), "--aot", "--aot_check",
         "--aot_episodes", "1", "--device", "cuda"])
    if "smoke check OK: logits (1, 5, 5)" not in printed:
        raise AssertionError("cli.export --aot_check printed no smoke check")
    add(read_counts(), 2)
    t0 = time.perf_counter()
    program, manifest = aot.load_program(artifact)
    nodes = aot.op_nodes(program)
    del program
    scorer, _ = aot.load_serving_artifact(artifact)
    load_s = time.perf_counter() - t0
    log(f"[serve] scorer artifact {artifact.name}: {artifact.stat().st_size / 1e6:.1f} MB; "
        f"cli.export --aot --aot_check {export_s:.2f} s (torch.export.export "
        f"{secs['export']:.2f} s, torch.export.save {secs['save']:.2f} s, then a "
        f"reload and one check), load {load_s:.2f} s; {nodes} litemkd.tct_attention nodes; "
        f"manifest {json.dumps({k: manifest[k] for k in ('platforms', 'device', 'torch_version', 'episodes', 'input_dtypes')})}")
    if nodes != 2 or manifest["platforms"] != ["cuda"]:
        raise AssertionError(f"scorer artifact: {nodes} TCT nodes, {manifest['platforms']}")
    sampler = build_sampler(cfg, need_teacher=False)
    t0 = time.perf_counter()
    batches = [sampler.sample_batch(np.random.default_rng(1000 + i), 1, train=False)
               for i in range(SERVE_REQUESTS)]
    sample_s = time.perf_counter() - t0
    eager = cli_test.load_student(cfg, str(ckpt), "cuda")

    def eager_fn(sup, lab, qry):
        with torch.inference_mode():
            return merge_logits(cfg.distill.name, eager(sup, lab, qry)["logits"])

    got, counts = _serve_requests("scorer artifact", scorer, batches, sample_s)
    add(counts, 2 * SERVE_REQUESTS)
    want, counts = _serve_requests("eager BatchedStudent", eager_fn, batches, sample_s)
    add(counts, 2 * SERVE_REQUESTS)
    got, want = torch.stack(got), torch.stack(want)
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    same = torch.equal(got.argmax(-1), want.argmax(-1))
    truth = torch.from_numpy(np.stack([b.query_labels for b in batches]))
    acc = (got.argmax(-1) == truth).float().mean().item()
    log(f"[serve] {SERVE_REQUESTS} requests of 1 episode: artifact vs eager "
        f"max_abs_err {err:.3e} (max|logit| {scale:.3e}); predictions equal: {same}; "
        f"accuracy {acc:.3f}; {label}")
    if not same or not err <= 1e-3 * scale:
        raise AssertionError(f"the scorer artifact differs from eager: {err} of {scale}")
    del eager, scorer, batches
    torch.cuda.empty_cache()

    # (c) the MFM's extract artifact against eager extraction
    extract = mfm_run / "extract.litemkd"
    zero_counts()
    printed, export_s, secs = _export_aot(
        ["--ckpt", str(mfm_ckpt), "--out", str(extract), "--aot", "--mfm",
         "--aot_batch", str(SERVE_EXTRACT_BATCH), "--aot_check", "--device", "cuda"])
    if "smoke check OK: fused" not in printed:
        raise AssertionError("cli.export --aot --mfm --aot_check printed no smoke check")
    t0 = time.perf_counter()
    extractor, manifest = aot.load_serving_artifact(extract)
    load_s = time.perf_counter() - t0
    files = sorted((run_root / "tree" / "rgb").glob("*/*/feature.npy"))[:SERVE_EXTRACT_BATCH]
    feats = {}
    for m in mcfg.model.modalities:
        paths = [run_root / "tree" / m / f.parent.parent.name / f.parent.name / "feature.npy"
                 for f in files]
        feats[m] = torch.from_numpy(np.stack([
            np.load(p) if p.exists() else np.zeros_like(np.load(files[0]))
            for p in paths])).to("cuda")
    fused = extractor(feats)
    with torch.device("cuda"):
        teacher = make_mfm(mcfg)
    teacher.load_state_dict(torch.load(mfm_ckpt, map_location="cpu",
                                       weights_only=True)["model_state_dict"])
    teacher.eval()

    def eager_extract():
        with torch.inference_mode():
            return teacher.extract(feats)

    ref = eager_extract()
    err, scale = (fused - ref).abs().max().item(), ref.abs().max().item()
    art_ms = cuda_ms(lambda: extractor(feats), 10)
    eager_ms = cuda_ms(eager_extract, 10)
    add(read_counts(), 0)
    log(f"[serve] extract artifact {extract.name}: {extract.stat().st_size / 1e9:.3f} GB; "
        f"cli.export --aot --mfm --aot_check {export_s:.2f} s (torch.export.export "
        f"{secs['export']:.2f} s, torch.export.save {secs['save']:.2f} s), load "
        f"{load_s:.2f} s; "
        f"{SERVE_EXTRACT_BATCH} videos of phase 6's tree: max_abs_err {err:.3e} vs eager "
        f"extract (max|x| {scale:.3e}); {SERVE_EXTRACT_BATCH / art_ms * 1e3:.3f} videos/s "
        f"on the device ({art_ms:.3f} ms a batch; eager {eager_ms:.3f} ms); {label}")
    if not err <= 1e-5 * scale:
        raise AssertionError(f"the extract artifact differs from eager: {err} of {scale}")
    del extractor, teacher, fused, ref, feats
    torch.cuda.empty_cache()

    # (d) the demo from the artifact and from the checkpoint, then as a server
    rows = {}
    for name, path in (("artifact", artifact), ("checkpoint", ckpt)):
        zero_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_demo.main(["-m", str(path), "--once", "--device", "cuda"])
        rows[name] = json.loads(buf.getvalue())
        add(read_counts(), 2)
        log(f"[serve] cli.demo --once from the {name}: {time.perf_counter() - t0:.2f} s, "
            f"predictions {[r['predicted'] for r in rows[name]]}, truth "
            f"{[r['true'] for r in rows[name]]}")
    if [r["predicted"] for r in rows["artifact"]] != \
            [r["predicted"] for r in rows["checkpoint"]]:
        raise AssertionError(f"the demo's predictions differ: {rows}")
    _demo_server(artifact, run_root / "demo_server.log")

    # (e) the host tools
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pipeline_bench.main(["--episodes", "2", "--img", "112", "--way", "5",
                             "--shot", "1", "--frames", "8"])
    log("[serve] tools.pipeline_bench --episodes 2 --img 112 --shot 1: "
        + "; ".join(buf.getvalue().strip().splitlines()))
    if "PIL decode" not in buf.getvalue():
        raise AssertionError("pipeline_bench printed no PIL rate")
    frames = run_root / "frames"
    t0 = time.perf_counter()
    n = shrink_dataset.shrink(str(frames), str(run_root / "frames_l8"), 8)
    videos = sorted(d for d in frames.glob("*/*") if d.is_dir())
    kept = [len(list((run_root / "frames_l8" / v.parent.name / v.name).iterdir()))
            for v in videos]
    log(f"[serve] tools.shrink_dataset of phase 7's tree: {n} videos of {len(videos)}, "
        f"frames a video {sorted(set(kept))}, {time.perf_counter() - t0:.2f} s")
    if n != len(videos) or set(kept) != {8}:
        raise AssertionError(f"shrink_dataset: {n} of {len(videos)} videos, {set(kept)}")
    log(f"[serve] phase 12 launches {total}; took {time.perf_counter() - t_phase:.2f} s")
    return total


# ---------------------------------------------------------------------------
# Analysis tools and data-parallel training (phase 13)
# ---------------------------------------------------------------------------

# params of the README's efficiency table: the JAX package's
# count_params(variables["params"]) at each preset
FLOPS_PARAMS = {"student_fc2sup_dist": 22_719_552, "expert_trx": 32_949_824,
                "student_mobilenet": 16_350_000}
# 4-episode batches (one micro-batch chunk of the flagship): the host draws
# the synthetic clips of an episode in ~1.9 s (phase 5's CLI run)
PHASE13_EPISODES = 4
PROFILE_ARGV = ["--steps", "1", "--tasks_per_batch", str(PHASE13_EPISODES),
                "--micro_batch", str(PHASE13_EPISODES), "--device", "cuda"]
DP_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
           "--pallas_bn", "--tasks_per_batch", str(PHASE13_EPISODES),
           "--training_iterations", str(PHASE13_EPISODES), "--print_freq", "1",
           "--device", "cuda"]


def _repo_env():
    repo = Path(__file__).resolve().parent
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def profile_launches(cfg, steps):
    """Kernel launches of ``steps`` student train steps of ``cfg`` (the
    profile's warm-up and traced steps): :func:`chunk_launches` a chunk."""
    chunks = steps * cfg.train.tasks_per_batch // (cfg.train.micro_batch
                                                    or cfg.train.tasks_per_batch)
    return {k: v * chunks for k, v in chunk_launches(cfg).items()}


def _profile(label, argv, want, names, out):
    """``cli.profile`` with ``argv``: its launches must be ``want`` and its
    summary must name each op of ``names``; returns the launches."""
    from litemkd_torch.cli import profile as cli_profile
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        buckets = cli_profile.main(argv + PROFILE_ARGV + ["--out", str(out)])
    secs = time.perf_counter() - t0
    counts = read_counts()
    lines = [line.strip() for line in buf.getvalue().strip().splitlines()]
    at = next(i for i, line in enumerate(lines) if line.startswith("device op time"))
    ops = [line for line in lines[at + 1:] if "litemkd::" in line]
    log(f"[analysis] cli.profile {' '.join(argv)}: {secs:.2f} s, launches "
        f"{counts}; summary: " + " | ".join(lines[at:at + 4] + ops[:3]))
    if counts != want:
        raise AssertionError(f"cli.profile launches {counts} != {want}")
    for name in names:
        if not any(k.startswith(name + " ") for k in buckets):
            raise AssertionError(f"the profile summary names no {name} kernel: "
                                 f"{sorted(buckets)[:20]}")
    if not list(out.glob("*.pt.trace.json")):
        raise AssertionError(f"cli.profile wrote no trace under {out}")
    return counts


def _loss_of(ckdir):
    (step,) = [r for r in _train_records(ckdir) if "task_loss" in r]
    return step["task_loss"]


def dp_step_time(label):
    """The data-parallel train step at one rank (a NCCL group of one;
    gradients and metrics all-reduced, the running statistics snapshot)
    beside the plain step, cuDNN BatchNorm, on one 16-episode batch on the
    card: CUDA events over 3 steps after one warm-up, in one process."""
    import torch.distributed as dist
    from litemkd_torch.parallel import DataParallel
    cfg = preset("student_fc2sup_dist")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    try:
        dp = DataParallel(0, 1, torch.device("cuda", 0))
        batch = device_batch(cfg, TRAIN_EPISODES)
        times = {}
        for name, group in (("plain", None), ("data-parallel", dp)):
            state = create_train_state(cfg, "cuda")
            step = make_train_step(cfg, group)
            times[name] = cuda_ms(lambda: step(state, batch), 3, warmup=1)
            del state
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(f"[dp] device step at one rank: data-parallel {times['data-parallel']:.3f} ms, "
        f"plain {times['plain']:.3f} ms ({TRAIN_EPISODES} episodes, micro-batch "
        f"{cfg.train.micro_batch}, cuDNN BatchNorm); {label}")
    return times


def analysis_path(label, run_root):
    """Phase 13 on phase 7's tree and phase 8's pretrain checkpoint:
    ``cli.flops``, ``cli.profile``, ``cli.figures cam``, and ``cli.train``
    under ``torch.distributed.run`` against a plain run. Returns the
    phase's launch counts (those of its two profiles)."""
    from litemkd_torch.cli import figures as cli_figures
    from litemkd_torch.cli import flops as cli_flops
    from litemkd_torch.utils.saliency import backbone_predict
    t_phase = time.perf_counter()

    # (a) params and forward FLOPs at full width, counted under FakeTensorMode
    zero_counts()
    for name, want in FLOPS_PARAMS.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            r = cli_flops.main(["--preset", name, "--device", "cuda"])
        log(f"[analysis] cli.flops --preset {name} on the card: {r['params']} params, "
            f"{r['gflops']:.3f} GFLOPs/episode forward (FlopCounterMode), "
            f"{time.perf_counter() - t0:.2f} s")
        if r["params"] != want or not r["gflops"] > 0:
            raise AssertionError(f"cli.flops {name}: {r}, expected {want} params")
    if read_counts() != dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0):
        raise AssertionError(f"cli.flops launched kernels: {read_counts()}")

    # (b) profiles of the student's BN-kernel step and of the MFM's step
    base = preset("student_fc2sup_dist")
    cfg = base.replace(model=dataclasses.replace(base.model, pallas_bn=True),
                       train=dataclasses.replace(base.train,
                                                 tasks_per_batch=PHASE13_EPISODES,
                                                 micro_batch=PHASE13_EPISODES))
    total = _profile(label, ["--preset", "student_fc2sup_dist", "--path", "train",
                             "--pallas_bn"], profile_launches(cfg, 2),
                     ("litemkd::tct_attention", "litemkd::bn_sums",
                      "litemkd::bn_bwd_sums"), run_root / "trace_train")
    mfm = _profile(label, ["--preset", "mfm_teacher", "--path", "teacher"],
                   dict(tct_attention=2, bn_sums=0, bn_bwd_sums=0),
                   ("litemkd::tct_attention",), run_root / "trace_teacher")
    total = {k: total[k] + mfm[k] for k in total}
    torch.cuda.empty_cache()

    # (c) Grad-CAM of a frame of phase 7's tree through phase 8's checkpoint
    frame = sorted((run_root / "frames").rglob("*.jpg"))[0]
    out = run_root / "cam.jpg"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_figures.main(["cam", "--image", str(frame), "--ckpt",
                          str(run_root / "pretrain"), "--arch", "resnet50",
                          "--out", str(out), "--device", "cuda"])
    secs = time.perf_counter() - t0
    cls = int(buf.getvalue().split("Grad-CAM class ")[1].split()[0])
    net = cli_figures.load_cam_model(str(run_root / "pretrain"), "resnet50", None,
                                     "cuda")
    rgb = np.asarray(Image.open(frame).convert("RGB").resize((224, 224)),
                     dtype=np.float32) / 255.0
    logits = backbone_predict(net, rgb[None])
    with Image.open(out) as im:
        size = im.size
    log(f"[analysis] cli.figures cam of {frame.relative_to(run_root)} through "
        f"{net.fc.out_features}-class resnet50 pretrain checkpoint: class {cls} "
        f"(logit {logits[0, cls]:.4f}), overlay {out.name} {size}, {secs:.2f} s")
    if cls != int(np.argmax(logits[0])) or size != (224, 224):
        raise AssertionError(f"cam: class {cls} vs argmax {np.argmax(logits[0])}, "
                             f"overlay {size}")
    del net
    torch.cuda.empty_cache()

    # (d) one data-parallel step under torch.distributed.run (NCCL, one
    # rank) against a plain run of the same seed
    repo = Path(__file__).resolve().parent
    dp_dir, plain_dir = run_root / "dp_run", run_root / "plain_run"
    t0 = time.perf_counter()
    with open(run_root / "torchrun.log", "w") as f:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
             "--master_addr", "localhost", "--master_port", str(_free_port()),
             "-m", "litemkd_torch.cli.train"] + DP_ARGV
            + ["--mesh_data", "1", "-c", str(dp_dir)],
            cwd=repo, stdout=f, stderr=subprocess.STDOUT, timeout=600,
            env=_repo_env())
    dp_secs = time.perf_counter() - t0
    text = (run_root / "torchrun.log").read_text()
    if r.returncode != 0 or "mesh 1x1 over 1 ranks" not in text:
        raise AssertionError(f"torch.distributed.run cli.train exit {r.returncode}: "
                             f"{text[-3000:]}")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_train.main(DP_ARGV + ["-c", str(plain_dir)])
    got, want = _loss_of(dp_dir), _loss_of(plain_dir)
    log(f"[dp] cli.train --mesh_data 1 under torch.distributed.run (NCCL, 1 rank): "
        f"task_loss {got:.6f} vs {want:.6f} in a plain run of the same seed; "
        f"{dp_secs:.2f} s of command")
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError(f"data-parallel loss {got} != plain {want}")
    dp_step_time(label)
    log(f"[analysis] phase 13 launches {total}; took "
        f"{time.perf_counter() - t_phase:.2f} s")
    return total


# ---------------------------------------------------------------------------
# Tensor-parallel training: the mesh's model axis (phase 14)
# ---------------------------------------------------------------------------

# 4-episode steps: one micro-batch chunk of the flagship, the same count for
# the MFM (the host draws the flagship's synthetic clips at ~1.9 s an episode)
TP_EPISODES = 4
TP_STUDENT_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
                   "--pallas_bn", "--tasks_per_batch", str(TP_EPISODES),
                   "--micro_batch", str(TP_EPISODES), "--training_iterations",
                   str(2 * TP_EPISODES), "--print_freq", "1", "--device", "cuda"]
# on phase 6's feature tree (at the synthetic source's noise every CE is 0)
TP_MFM_ARGV = ["--preset", "mfm_teacher", "--dataset", "hmdb",
               "--tasks_per_batch", str(TP_EPISODES), "--training_iterations",
               str(2 * TP_EPISODES), "--print_freq", "1", "--device", "cuda"]


def tp_mfm_argv(run_root):
    tree = run_root / "tree"
    return TP_MFM_ARGV + ["--feature_root", str(tree), "--traintestlist",
                          str(tree / "splits")]


def tp_configs():
    """The flagship (BN kernels on, 16 episodes in chunks of 4) and the MFM
    (16 episodes at once) as their device-resident steps run."""
    base = preset("student_fc2sup_dist")
    student = base.replace(model=dataclasses.replace(base.model, pallas_bn=True))
    return {"student_fc2sup_dist": (
                student, lambda: create_train_state(student, "cuda"),
                make_train_step, lambda: device_batch(student, TRAIN_EPISODES)),
            "mfm_teacher": (
                preset("mfm_teacher"),
                lambda: create_mfm_train_state(preset("mfm_teacher"), "cuda"),
                make_mfm_train_step,
                lambda: mfm_device_batch(preset("mfm_teacher"), TRAIN_EPISODES, True))}


def tp_step_times(dp=None):
    """Each model's full-width step on a batch made on the card from a seed:
    the first step's loss, the device ms of the next 3 (CUDA events), the
    kernel launches of one more and the peak memory: one card (``dp``
    None) or this rank's share of a tensor-parallel step over ``dp``'s
    mesh."""
    from litemkd_torch.train import shard_train_state
    out = {}
    for name, (cfg, make, make_step, make_batch) in tp_configs().items():
        state = make()
        if dp is not None:
            shard_train_state(state, dp.axis)
        step, batch = make_step(cfg, dp), make_batch()
        torch.cuda.reset_peak_memory_stats()
        loss = float(step(state, batch)["task_loss"])
        ms = cuda_ms(lambda: step(state, batch), 3, warmup=0)
        zero_counts()
        step(state, batch)
        torch.cuda.synchronize()
        out[name] = dict(loss=loss, ms=ms, launches=read_counts(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del state, batch
        torch.cuda.empty_cache()
    return out


def tp_layers_check(label):
    """Phase 14 on one card: the flagship student (with its frozen teacher)
    and the MFM at full width, cut by ``shard_model`` at M = 1 over a
    one-rank NCCL group (every parallel module built, every collective
    run), against the unsharded models from the same seed on the same
    batch: the loss (rel 1e-4) and the gradients (their difference's norm
    within 1e-3 of theirs; the largest elementwise deviation is printed:
    where the row layers add their bias after the product, not in it, a
    last-bit change can flip a ReLU at its kink in the MFM's MLPs, and
    that moves single elements by up to ~1e-2 of max|g|, measured on the
    card).
    The student runs its trunk in fp32 here, on 2 episodes: in bf16 a
    last-bit change in the head's gradient moves the trunk's by bf16
    steps (1e-2 of the largest, measured at tiny width on the CPU), which
    would hide what this checks. Returns the launches of the two
    tensor-parallel steps, counted around them alone."""
    import torch.distributed as dist
    from litemkd_torch.parallel import ModelAxis, sharded_parameters
    from litemkd_torch.train import shard_train_state
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=torch.device("cuda", 0))
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)
    try:
        axis = ModelAxis(dist.group.WORLD, 1, 0)
        for name, (cfg, make, make_step, _) in tp_configs().items():
            if name.startswith("student"):
                e = 2
                cfg = cfg.replace(model=dataclasses.replace(
                    cfg.model, compute_dtype="float32"))
                batch = device_batch(cfg, e)
                make = functools.partial(create_train_state, cfg, "cuda")
            else:
                e = TP_EPISODES
                batch = mfm_device_batch(cfg, e, True)
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, tasks_per_batch=e,
                micro_batch=e if cfg.train.micro_batch else 0))
            step = make_step(cfg)
            plain = make()
            want = float(step(plain, batch)["task_loss"])
            tp = shard_train_state(make(), axis)
            n_cut = len(sharded_parameters(tp.model))
            zero_counts()
            got = float(step(tp, batch)["task_loss"])
            torch.cuda.synchronize()
            counts = read_counts()
            total = {k: total[k] + counts[k] for k in total}
            grads = {n: p.grad for n, p in plain.model.named_parameters()
                     if p.grad is not None}
            g_max = max(float(g.abs().max()) for g in grads.values())
            err, worst = max((float((p.grad - grads[n]).abs().max()), n)
                             for n, p in tp.model.named_parameters()
                             if p.grad is not None)
            rel = math.sqrt(sum(float(((p.grad - grads[n]).double() ** 2).sum())
                                for n, p in tp.model.named_parameters()
                                if p.grad is not None)
                            / sum(float((g.double() ** 2).sum())
                                  for g in grads.values()))
            plain_ms = cuda_ms(lambda: step(plain, batch), 3, warmup=1)
            tp_ms = cuda_ms(lambda: step(tp, batch), 3, warmup=1)
            log(f"[tp] {name} at full width, {n_cut} weights cut by shard_model at "
                f"M = 1 (one-rank NCCL group): task_loss {got:.6f} vs {want:.6f} "
                f"unsharded; gradients off by {rel:.3e} in norm, at most "
                f"{err / g_max:.3e} of max|g| ({worst}); "
                f"launches {counts}; {e}-episode step {tp_ms:.3f} ms vs "
                f"{plain_ms:.3f} ms unsharded; {label}")
            if not abs(got - want) <= 1e-4 * abs(want) or not rel <= 1e-3:
                raise AssertionError(f"tensor-parallel {name} at M = 1: loss {got} vs "
                                     f"{want}, gradients off by {rel} in norm")
            if n_cut == 0 or counts["tct_attention"] == 0:
                raise AssertionError(f"{name}: {n_cut} weights cut, launches {counts}")
            del plain, tp, batch, grads
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


def tp_worker(out_dir, d, m, tasks):
    """One rank of ``chip_smoke.py --tp-worker OUT D M TASKS`` under
    ``torch.distributed.run`` (one card a rank): ``cli`` runs
    ``cli.train_teacher`` and ``cli.train`` at (D, M) with the launches
    read around each; ``time`` the device-resident steps of
    :func:`tp_step_times`; ``test`` ``cli.test`` of the student checkpoint
    that the ``cli`` task of an earlier call wrote. Writes
    ``OUT/rank<r>.json``."""
    from litemkd_torch.cli.common import setup_data_parallel
    from litemkd_torch.config import MeshConfig
    out = Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = ["--mesh_data", str(d), "--mesh_model", str(m)]
    dp, _ = setup_data_parallel(preset("tiny").replace(mesh=MeshConfig(d, m)),
                                "cuda")
    res = {"rank": dp.rank}
    if "cli" in tasks:
        for name, cli, argv in (("mfm", cli_teacher.main, tp_mfm_argv(out.parent)),
                                ("student", cli_train.main, TP_STUDENT_ARGV)):
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli(argv + flags + ["-c", str(out / name)])
            torch.cuda.synchronize()
            res[name] = dict(launches=read_counts(),
                             seconds=time.perf_counter() - t0)
    if "time" in tasks:
        res["steps"] = tp_step_times(dp)
    if "test" in tasks:
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            res["test"] = cli_test.main(
                ["-m", str(out.parent / "tp_1x2" / "student" / "checkpoint_8.pt"),
                 "--num_test_tasks", "8", "--device", "cuda"] + flags)
        res["test_launches"] = read_counts()
    with open(out / f"rank{dp.rank}.json", "w") as f:
        json.dump(res, f)
    dp.barrier()


def _tp_run(run_root, d, m, tasks):
    """``chip_smoke.py --tp-worker`` over D·M cards; every rank's record."""
    repo = Path(__file__).resolve().parent
    out = run_root / f"tp_{d}x{m}"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out / "torchrun.log", "w") as f:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
             str(d * m), "--master_addr", "localhost", "--master_port",
             str(_free_port()), str(repo / "chip_smoke.py"), "--tp-worker",
             str(out), str(d), str(m), tasks],
            cwd=repo, stdout=f, stderr=subprocess.STDOUT, timeout=900,
            env=_repo_env())
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"tensor-parallel run at ({d}, {m}) exit {r.returncode}: "
                             f"{(out / 'torchrun.log').read_text()[-4000:]}")
    return [json.loads((out / f"rank{k}.json").read_text())
            for k in range(d * m)], secs


def _losses(ckdir):
    return [r["task_loss"] for r in _train_records(ckdir)]


def tp_cards_path(label, run_root):
    """Phase 14 over several cards (NCCL, one rank a card): ``cli.train_teacher
    --preset mfm_teacher`` and ``cli.train --preset student_fc2sup_dist`` at
    (data 1, model 2), 2 steps of 4 episodes each (the MFM on phase 6's
    feature tree, written here where it is missing), against the same
    commands on one card (the MFM's losses rel 1e-4; the student's first
    step rel 1e-4, its second, after an update through the bf16 trunk,
    reported), with each rank's launches; the device-resident steps per
    rank at M = 2 (and 4) beside one card's (the first step's loss rel
    1e-4, the launches equal); on four cards ``cli.test`` of the student's
    checkpoint at (2, 2). Returns the launches of rank 0's CLI runs, or
    None below 2 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[tp] the cross-card tensor-parallel runs need 2 cards; this machine "
            f"has {n}: the model axis ran at M = 1 only; {label}")
        return None
    if not (run_root / "tree").exists():
        write_feature_tree(run_root / "tree", preset("mfm_teacher").episode.seq_len,
                           preset("mfm_teacher").model.trans_linear_in_dim)
    ref = {}
    for name, cli, argv in (("mfm", cli_teacher.main, tp_mfm_argv(run_root)),
                            ("student", cli_train.main, TP_STUDENT_ARGV)):
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            cli(argv + ["-c", str(run_root / "tp_ref" / name)])
        ref[name] = (_losses(run_root / "tp_ref" / name), read_counts())
    one = tp_step_times()
    ranks, secs = _tp_run(run_root, 1, 2, "cli,time")
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)
    for name in ("mfm", "student"):
        got = _losses(run_root / "tp_1x2" / name)
        want, launches = ref[name]
        per_rank = [r[name]["launches"] for r in ranks]
        log(f"[tp] cli {name} at (data 1, model 2) on 2 cards: task_loss {got} vs "
            f"{want} on one card; launches per rank {per_rank} (one card {launches}); "
            f"{label}")
        steps = got if name == "mfm" else got[:1]
        if len(got) != len(want) or not all(
                abs(a - b) <= 1e-4 * abs(b) for a, b in zip(steps, want)):
            raise AssertionError(f"tensor-parallel {name} losses {got} != {want}")
        if any(p != launches for p in per_rank):
            raise AssertionError(f"{name}: launches per rank {per_rank} != {launches}")
        total = {k: total[k] + per_rank[0][k] for k in total}
    meshes = {(1, 2): ranks}
    if n >= 4:
        meshes[(1, 4)], _ = _tp_run(run_root, 1, 4, "time")
        test_ranks, _ = _tp_run(run_root, 2, 2, "test")
        zero_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            want = cli_test.main(["-m", str(run_root / "tp_1x2" / "student" /
                                            "checkpoint_8.pt"),
                                  "--num_test_tasks", "8", "--device", "cuda"])
        got = test_ranks[0]["test"]
        log(f"[tp] cli.test of the (1, 2) checkpoint at (data 2, model 2): "
            f"{got} vs {want} on one card; launches per rank "
            f"{[r['test_launches'] for r in test_ranks]}; {label}")
        if abs(got["accuracy"] - want["accuracy"]) > 1e-4 or \
                got["n_tasks"] != want["n_tasks"]:
            raise AssertionError(f"sharded eval {got} != {want}")
    for (d, m), rs in meshes.items():
        for name in one:
            steps = [r["steps"][name] for r in rs]
            log(f"[tp] {name} device step ({TRAIN_EPISODES} episodes) at (data {d}, "
                f"model {m}): first task_loss {steps[0]['loss']:.6f} (one card "
                f"{one[name]['loss']:.6f}); per rank ms "
                f"{[round(x['ms'], 3) for x in steps]}, peak GiB "
                f"{[round(x['peak_gib'], 3) for x in steps]}, launches "
                f"{steps[0]['launches']}; one card {one[name]['ms']:.3f} ms, "
                f"{one[name]['peak_gib']:.3f} GiB, launches {one[name]['launches']}; "
                f"{label}")
            if not all(abs(x["loss"] - one[name]["loss"])
                       <= 1e-4 * abs(one[name]["loss"]) for x in steps) or \
                    any(x["launches"] != one[name]["launches"] for x in steps):
                raise AssertionError(f"tensor-parallel {name} step at ({d}, {m}): "
                                     f"{steps} vs one card {one[name]}")
    log(f"[tp] cross-card runs took {secs:.2f} s of command at (1, 2)")
    return total


def tp_path(label, run_root):
    """Phase 14: the model axis at M = 1 on this card, then across cards
    where there are several. Returns the launches of the path's runs."""
    t0 = time.perf_counter()
    total = tp_layers_check(label)
    cards = tp_cards_path(label, run_root)
    if cards is not None:
        total = {k: total[k] + cards[k] for k in total}
    log(f"[tp] phase 14 launches {total}; took {time.perf_counter() - t0:.2f} s")
    return total


# ---------------------------------------------------------------------------
# Micro-batch chunks over some data ranks but not all (phase 15)
# ---------------------------------------------------------------------------

# (world, episodes, micro_batch): each chunk over two of four ranks (every
# rank's geometry at the flagship's 16 episodes over 8 ranks), and chunks
# off the ranks' boundaries
SPAN_LAYOUTS = [(4, 8, 4), (2, 6, 2)]
SPAN_SEED = 5
SPAN_TIMED = 2      # timed steps after the compared one and a warm-up
# the steps each layout compares: the flagship as it trains (bf16 trunk),
# and the same in fp32 with every BatchNorm bias at +3, the multi-card
# test's conditions (off the ReLU kinks, where a last-bit change of a
# pre-activation flips a mask), with remat so that four fp32 ranks fit on
# one card
SPAN_VARIANTS = {
    "bf16": dict(dtype="bfloat16", bias=None, remat=False),
    "fp32": dict(dtype="float32", bias=3.0, remat=True),
}
SPAN_CLI_ARGV = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
                 "--pallas_bn", "--trans_dropout", "0", "--print_freq", "1",
                 "--device", "cuda"]


def span_cfg(episodes, micro, variant="bf16"):
    """The flagship with the BN kernels, dropout 0 (a rank draws its masks
    at its own shapes), ``episodes`` a step in chunks of ``micro``, in the
    precision and remat of ``variant``."""
    v = SPAN_VARIANTS[variant]
    base = preset("student_fc2sup_dist")
    return base.replace(
        model=dataclasses.replace(base.model, pallas_bn=True, trans_dropout=0.0,
                                  compute_dtype=v["dtype"], remat=v["remat"]),
        train=dataclasses.replace(base.train, tasks_per_batch=episodes,
                                  micro_batch=micro))


def span_state(cfg, variant):
    state = create_train_state(cfg, "cuda")
    if SPAN_VARIANTS[variant]["bias"] is not None:
        with torch.no_grad():
            for m in state.model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.bias.fill_(SPAN_VARIANTS[variant]["bias"])
    return state


def _span_step(state, step, batch):
    """One step on cuDNN's deterministic algorithms (two runs of a step
    otherwise differ in the order of its atomics), its metrics as floats
    and its launches."""
    zero_counts()
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        metrics = step(state, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = before
    return {k: float(v) for k, v in metrics.items()}, read_counts()


def _span_cpu(tensors):
    return {k: v.detach().float().cpu() for k, v in tensors.items()}


def _grads(model):
    return _span_cpu({n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None})


def grad_deviation(grads, want):
    """max |g − want| / max|want| over every parameter, and where."""
    g_max = max(g.abs().max().item() for g in want.values())
    dev = {k: (grads[k] - g).abs().max().item() / g_max for k, g in want.items()}
    worst = max(dev, key=dev.get)
    return dev[worst], worst


def span_reference(episodes, micro, variant, out, timed=False):
    """The one-process step of ``variant`` on the card, on the whole batch:
    its metrics, state dict, gradients and launches, saved to ``out``
    (``reference_<variant>.pt``); returns them with the peak memory (with
    ``timed``, the device ms of the next steps), ``floor``: how far the same step's
    gradients move (over max|g|, with where) when the episodes of each
    chunk run in reverse order, which changes nothing but the order of
    the arithmetic, and ``floor_loss``, how far its loss moves (relative)."""
    from litemkd_torch.parallel.data_parallel import chunk_size
    cfg = span_cfg(episodes, micro, variant)
    state = span_state(cfg, variant)
    batch = device_batch(cfg, episodes, SPAN_SEED)
    step = make_train_step(cfg)
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = _span_step(state, step, batch)
    ref = dict(metrics=metrics, launches=launches,
               state=_span_cpu(state.model.state_dict()),
               grads=_grads(state.model),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(ref, out / f"reference_{variant}.pt")
    state.model.load_state_dict(start)
    del start
    size = chunk_size(micro, episodes)
    order = torch.arange(episodes, device="cuda").view(-1, size).flip(1).reshape(-1)
    again, _ = _span_step(state, step, EpisodeBatch(*(x[order] for x in batch)))
    ref["floor"] = grad_deviation(_grads(state.model), ref["grads"])
    ref["floor_loss"] = abs(again["task_loss"] / metrics["task_loss"] - 1)
    if timed:
        ref["ms"] = cuda_ms(lambda: step(state, batch), SPAN_TIMED, warmup=1)
    del state, batch
    torch.cuda.empty_cache()
    return ref


def span_deviation(metrics, state, grads, ref):
    """How far a data-parallel step's results lie from the one-process
    step's: the largest relative metric deviation (and the loss's), the
    largest excess of a parameter or buffer over rtol 1e-4 (with where),
    and the largest gradient deviation over max|g| (with where)."""
    rel = {k: abs(metrics[k] - v) / max(abs(v), 1e-6)
           for k, v in ref["metrics"].items()}
    excess = {k: ((state[k] - w).abs() - 1e-4 * w.abs()).max().item()
              for k, w in ref["state"].items()}
    worst_state = max(excess, key=excess.get)
    grad_dev, grad_worst = grad_deviation(grads, ref["grads"])
    return dict(metric=max(rel.values()), loss=rel["task_loss"],
                state=excess[worst_state], state_at=worst_state,
                grad=grad_dev, grad_at=grad_worst,
                names_equal=set(grads) == set(ref["grads"]))


def span_worker(out_dir, rank, world, port, episodes, micro, variants):
    """One rank of one-card data-parallel steps: a gloo group of ``world``
    processes on ``cuda:0`` (NCCL takes one rank a card); for each of
    ``variants`` this rank's episodes of the batch of
    :func:`span_reference`, one step held against that one's, and (for
    the first) ``SPAN_TIMED`` timed steps. Writes ``OUT/rank<r>.json``."""
    import torch.distributed as dist
    from litemkd_torch.parallel import DataParallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(out_dir)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        dp = DataParallel(rank, world, torch.device("cuda", 0))
        local = episodes // world
        res = dict(rank=rank)
        for i, variant in enumerate(variants):
            cfg = span_cfg(episodes, micro, variant)
            state = span_state(cfg, variant)
            batch = EpisodeBatch(*(x[rank * local:(rank + 1) * local].clone()
                                   for x in device_batch(cfg, episodes, SPAN_SEED)))
            step = make_train_step(cfg, dp)
            torch.cuda.reset_peak_memory_stats()
            metrics, launches = _span_step(state, step, batch)
            r = dict(metrics=metrics, launches=launches,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            ref = torch.load(out / f"reference_{variant}.pt", weights_only=False)
            sd = _span_cpu(state.model.state_dict())
            r.update(span_deviation(metrics, sd, _grads(state.model), ref))
            r["checksum"] = sum(float(v.double().sum()) for v in sd.values())
            del ref, sd
            if i == 0:
                r["ms"] = cuda_ms(lambda: step(state, batch), SPAN_TIMED, warmup=1)
            res[variant] = r
            del state, batch
            torch.cuda.empty_cache()
        with open(out / f"rank{rank}.json", "w") as f:
            json.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def span_cli_worker(out_dir, argv):
    """One rank of ``cli.train`` under ``torch.distributed.run`` (NCCL, one
    card a rank) with the launches read around it; writes
    ``OUT/rank<r>.json``."""
    out = Path(out_dir)
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_train.main(argv + ["-c", str(out / "run")])
    torch.cuda.synchronize()
    rank = int(os.environ["RANK"])
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(dict(rank=rank, launches=read_counts()), f)


def _plan_launches(cfg, world, rank):
    """A rank's launches for its pieces of the chunk plan (every piece
    launches what a chunk does); one process's at ``world`` 1."""
    from litemkd_torch.parallel.data_parallel import chunk_plan
    t = cfg.train
    pieces = len(chunk_plan(t.micro_batch, t.tasks_per_batch, world, rank))
    return {k: v * pieces for k, v in chunk_launches(cfg).items()}


def _run_ranks(cmds, out, timeout):
    """Start every command at once; wait for all, killing the rest when
    one fails or the time is up."""
    logs = [open(out / f"log{i}.txt", "w") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=Path(__file__).resolve().parent, stdout=f,
                              stderr=subprocess.STDOUT, env=_repo_env())
             for c, f in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        logs = "".join((out / f"log{i}.txt").read_text()[-2000:]
                       for i in range(len(cmds)))
        raise AssertionError(f"ranks exited {codes}: {logs}")


def span_one_card(label, run_root):
    """Phase 15 on this card: each layout of ``SPAN_LAYOUTS`` as gloo
    ranks sharing the card, each step of ``SPAN_VARIANTS`` against the
    one-process step. Returns the launches of the compared steps (every
    rank's and the one-process steps')."""
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)
    for world, episodes, micro in SPAN_LAYOUTS:
        out = run_root / f"span_{world}x{episodes}"
        out.mkdir(parents=True, exist_ok=True)
        refs = {v: span_reference(episodes, micro, v, out, timed=i == 0)
                for i, v in enumerate(SPAN_VARIANTS)}
        port = _free_port()
        t0 = time.perf_counter()
        _run_ranks([[sys.executable, str(Path(__file__).resolve()), "--span-worker",
                     str(out), str(r), str(world), str(port), str(episodes),
                     str(micro), ",".join(SPAN_VARIANTS)] for r in range(world)],
                   out, 600)
        secs = time.perf_counter() - t0
        ranks = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(world)]
        for v in SPAN_VARIANTS:
            ref, got = refs[v], [x[v] for x in ranks]
            cfg = span_cfg(episodes, micro, v)
            want_one = _plan_launches(cfg, 1, 0)
            want = [_plan_launches(cfg, world, r) for r in range(world)]
            floor = ref["floor"]
            log(f"[span] student_fc2sup_dist {v} (BN kernels"
                f"{', remat' if SPAN_VARIANTS[v]['remat'] else ''}"
                f"{', BN biases +3' if SPAN_VARIANTS[v]['bias'] else ''}) at world "
                f"{world}, {episodes} episodes in chunks of {micro}, gloo ranks on "
                f"one card: task_loss {[x['metrics']['task_loss'] for x in got]} vs "
                f"{ref['metrics']['task_loss']} in one process; largest metric "
                f"deviation {max(x['metric'] for x in got):.3e}; largest state "
                f"excess over rtol 1e-4 {max(x['state'] for x in got):.3e} "
                f"({got[0]['state_at']}); gradient deviation "
                f"{[float('%.3e' % x['grad']) for x in got]} of max|g| "
                f"({got[0]['grad_at']}), the one-process step's own on its chunks' "
                f"episodes reversed {floor[0]:.3e} ({floor[1]}), its loss by "
                f"{ref['floor_loss']:.3e}; launches per rank {[x['launches'] for x in got]} (plan "
                f"{want}; one process {ref['launches']}); peak GiB per rank "
                f"{[round(x['peak_gib'], 3) for x in got]}, one process "
                f"{ref['peak_gib']:.3f}; {label}")
            if ref["launches"] != want_one:
                raise AssertionError(f"{v}: one-process launches {ref['launches']} "
                                     f"!= {want_one}")
            for x, w in zip(got, want):
                if x["launches"] != w or not x["names_equal"]:
                    raise AssertionError(f"{v} at world {world}: launches "
                                         f"{x['launches']} != {w}")
            if len({x["checksum"] for x in got}) != 1:
                raise AssertionError(f"{v}: the ranks' students differ")
            # gradients: at full width, running the episodes of each chunk
            # in another order moves the one-process step's own gradients
            # by ~7e-3 of max|g| in fp32 and ~0.3 in bf16 on an H100 (and
            # its bf16 loss by ~3e-4), so they are held to twice that move,
            # and to the multi-card test's bounds where those are larger
            if v == "fp32":
                # the bounds of tests/test_torch_port_cuda.py's multi-card test
                bad = [x for x in got if x["metric"] > 1e-4 or x["state"] > 1e-6
                       or x["grad"] > max(1e-3, 2 * floor[0])]
            else:
                # the bf16 trunk's rounding: an accuracy may flip
                bad = [x for x in got if x["grad"] > 2 * floor[0]
                       or x["loss"] > max(1e-4, 2 * ref["floor_loss"])]
            if bad:
                raise AssertionError(f"{v} at world {world}: {bad[0]}")
            total = {k: total[k] + ref["launches"][k]
                     + sum(x["launches"][k] for x in got) for k in total}
        v = next(iter(SPAN_VARIANTS))
        log(f"[span] {v} device ms a step per rank "
            f"{[round(x[v]['ms'], 3) for x in ranks]} beside {refs[v]['ms']:.3f} ms "
            f"in one process ({episodes} episodes): {world} ranks share one card "
            f"and stage every collective through the host (gloo), so this is no "
            f"scaling figure; {secs:.2f} s of ranks; {label}")
        shutil.rmtree(out, ignore_errors=True)
    return total


def concat_numpy(shards):
    """The global batch of the ranks' numpy shards, in rank order."""
    def cat(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], dict):
            return {k: cat(*(x[k] for x in xs)) for k in xs[0]}
        return np.concatenate(xs, axis=0)

    return type(shards[0])(*(cat(*f) for f in zip(*shards)))


def span_cards(label, run_root):
    """Phase 15 over several cards: ``cli.train --mesh_data D`` under
    ``torch.distributed.run`` (NCCL), 6 episodes in chunks of 2 at D = 2
    and 8 in chunks of 4 at D = 4 where there are four cards; each rank's
    launches against its pieces of the plan and the first loss against
    one process on the ranks' host batches concatenated (rel 1e-3: the
    bf16 trunk's rounding, as on one card). Returns the launches of rank
    0's runs, or None below 2 cards."""
    from litemkd_torch.parallel import host_rng
    n = torch.cuda.device_count()
    layouts = [(d, e, m) for d, e, m in ((2, 6, 2), (4, 8, 4)) if d <= n]
    if not layouts:
        log(f"[span] cli.train --mesh_data 2 and 4 need 2 and 4 cards; this "
            f"machine has {n}: the partial spans ran on one card only; {label}")
        return None
    if n < 4:
        log(f"[span] cli.train --mesh_data 4 needs 4 cards; this machine has "
            f"{n}; {label}")
    total = dict(tct_attention=0, bn_sums=0, bn_bwd_sums=0)
    for d, e, m in layouts:
        out = run_root / f"span_cli_{d}"
        out.mkdir(parents=True, exist_ok=True)
        argv = SPAN_CLI_ARGV + ["--tasks_per_batch", str(e), "--micro_batch",
                                str(m), "--training_iterations", str(e)]
        t0 = time.perf_counter()
        _run_ranks([[sys.executable, "-m", "torch.distributed.run",
                     "--nproc_per_node", str(d), "--master_addr", "localhost",
                     "--master_port", str(_free_port()),
                     str(Path(__file__).resolve()), "--span-cli-worker", str(out),
                     " ".join(argv + ["--mesh_data", str(d)])]], out, 900)
        secs = time.perf_counter() - t0
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(d)]
        (got,) = [r["task_loss"] for r in _train_records(out / "run")
                  if "task_loss" in r]
        _, cfg = cli_train.parse(argv)
        src = build_sampler(cfg)
        batch = concat_numpy([src.sample_batch(host_rng(cfg.train.seed, i, 0),
                                               e // d, train=True)
                              for i in range(d)])
        state = create_train_state(cfg, "cuda")
        metrics, one = _span_step(state, make_train_step(cfg),
                                  to_device(batch, torch.device("cuda")))
        del state
        torch.cuda.empty_cache()
        if one != _plan_launches(cfg, 1, 0):
            raise AssertionError(f"one-process launches {one}")
        want = [_plan_launches(cfg, d, r) for r in range(d)]
        log(f"[span] cli.train --mesh_data {d} ({e} episodes in chunks of {m}) on "
            f"{d} cards (NCCL): task_loss {got} vs {metrics['task_loss']} in one "
            f"process on the ranks' batches; launches per rank "
            f"{[r['launches'] for r in ranks]} (plan {want}); {secs:.2f} s of "
            f"command; {label}")
        if not abs(got - metrics["task_loss"]) <= 1e-3 * abs(metrics["task_loss"]):
            raise AssertionError(f"--mesh_data {d} loss {got} != {metrics}")
        if [r["launches"] for r in ranks] != want:
            raise AssertionError(f"--mesh_data {d} launches {ranks} != {want}")
        if not (out / "run" / f"checkpoint_{e}.pt").exists():
            raise AssertionError(f"rank 0 wrote no checkpoint_{e}.pt")
        total = {k: total[k] + ranks[0]["launches"][k] for k in total}
    return total


def span_path(label, run_root):
    """Phase 15: partial spans on this card, then across cards where there
    are several. Returns the launches of the path's runs."""
    t0 = time.perf_counter()
    total = span_one_card(label, run_root)
    cards = span_cards(label, run_root)
    if cards is not None:
        total = {k: total[k] + cards[k] for k in total}
    log(f"[span] phase 15 launches {total}; took {time.perf_counter() - t0:.2f} s")
    return total


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
    err_eval, tct_times = tct_phase()
    tct_grad_check(TRAIN, 5)
    tct_grad_check(RAGGED[0], 6)
    bn_times, bn_err = bn_phase()
    expert_bn_times, expert_bn_err = bn_phase(
        resnet50_bn_layers(), EXPERT_CHUNK_FRAMES, "expert_trx chunk (resnet50)",
        ragged=False)
    reference_check()
    train_reference_check()
    # against float64 on the CPU: at 32 px the CPU's own fp32 gradients of
    # this trunk are 1% of max|g| off its float64 ones, an H100's 2e-5
    train_reference_check("tiny fp32 student_mobilenet train step (mobilenetv3_large_2fc)"
                          ", cpu in float64", _mobilenet_bn_bias, "float64",
                          mean_by_spread=True, backbone="mobilenetv3_large_2fc", pallas_bn=False)

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

    # 6. MFM teacher: tiny card-vs-CPU, then full width through its CLIs
    mfm_reference_check()
    shutil.rmtree(run_root, ignore_errors=True)
    try:
        mfm_counts = mfm_main_path(card, run_root)
        mfm_device_rate(card, run_root)
        # 7. real video data: the student from a JPEG tree against the
        # fused features that phase 6 extracted
        video_counts = video_main_path(smi.splitlines()[0], run_root)
        # 8. the expert and pretrain stages on phase 7's tree, closing the
        # chain from frames
        expert_counts = expert_main_path(smi.splitlines()[0], run_root)
        # 9. the STRM and Baseline experts, DeiT pretraining and the eval
        # extras on the trees of phases 6 and 7
        zoo_counts = zoo_main_path(smi.splitlines()[0], run_root)
        # 10. the rest of the student zoo and the skeleton expert
        student_zoo_counts = student_zoo_path(smi.splitlines()[0], run_root)
        # 11. the fusion-teacher zoo on phase 6's tree and phase 8's expert
        fusion_counts = fusion_zoo_path(smi.splitlines()[0], run_root)
        # 12. serving: exports, artifacts and the demo on the checkpoints
        # of phases 6 and 7
        serve_counts = serving_path(smi.splitlines()[0], run_root)
        # 13. analysis tools and data-parallel training
        analysis_counts = analysis_path(smi.splitlines()[0], run_root)
        # 14. the mesh's model axis: tensor-parallel training and eval
        tp_counts = tp_path(smi.splitlines()[0], run_root)
        # 15. micro-batch chunks over some data ranks but not all
        span_counts = span_path(smi.splitlines()[0], run_root)
    finally:
        shutil.rmtree(run_root, ignore_errors=True)
    expert_device_rate(smi.splitlines()[0])
    t = tct_times["expert_train"]
    log(f"[expert] TCT kernel at the expert training shape {EXPERT_TRAIN}: kernel_ms="
        f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, split TF32)")
    for key, t in expert_bn_times.items():
        log(f"[expert] bn_{key} per expert_trx chunk: kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} (max_abs_err {expert_bn_err:.3e})")
    t = tct_times["ctx_train"]
    log(f"[zoo] TCT kernel at CTX's training shape {CTX_TRAIN}: kernel_ms="
        f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, split TF32)")
    t = tct_times["ctx_step"]
    log(f"[fusion] TCT kernel at the ctx head's 16-episode shape {CTX_STEP}: "
        f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms="
        f"{t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, "
        f"split TF32)")
    t = tct_times["serve"]
    log(f"[serve] TCT kernel at the serving request's shape {SERVE}: kernel_ms="
        f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, split TF32)")
    t = tct_times["mfm_train"]
    log(f"[mfm] TCT kernel at the MFM training shape {MFM_TRAIN}: kernel_ms="
        f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
        f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}, split TF32)")

    print(json.dumps({"kernels": [
        dict(name="tct_attention", route="cuda",
             source="litemkd_torch/csrc/tct_attention.cu",
             replaces="litemkd_tpu/ops/pallas_tct.py:61",
             launches=(counts["tct_attention"] + mfm_counts["tct_attention"]
                       + video_counts["tct_attention"]
                       + expert_counts["tct_attention"] + zoo_counts["tct_attention"]
                       + student_zoo_counts["tct_attention"]
                       + fusion_counts["tct_attention"]
                       + serve_counts["tct_attention"]
                       + analysis_counts["tct_attention"]
                       + tp_counts["tct_attention"]
                       + span_counts["tct_attention"]),
             max_abs_err=err_eval, **tct_times["eval"]),
        dict(name="bn_sums", route="cuda", source="litemkd_torch/csrc/bn_moments.cu",
             replaces="litemkd_tpu/ops/pallas_bn.py:73",
             launches=(counts["bn_sums"] + video_counts["bn_sums"]
                       + expert_counts["bn_sums"] + zoo_counts["bn_sums"]
                       + student_zoo_counts["bn_sums"] + fusion_counts["bn_sums"]
                       + analysis_counts["bn_sums"]
                       + tp_counts["bn_sums"] + span_counts["bn_sums"]),
             max_abs_err=bn_err, **bn_times["sums"]),
        dict(name="bn_bwd_sums", route="cuda",
             source="litemkd_torch/csrc/bn_moments.cu",
             replaces="litemkd_tpu/ops/pallas_bn.py:103",
             launches=(counts["bn_bwd_sums"] + video_counts["bn_bwd_sums"]
                       + expert_counts["bn_bwd_sums"] + zoo_counts["bn_bwd_sums"]
                       + student_zoo_counts["bn_bwd_sums"]
                       + fusion_counts["bn_bwd_sums"]
                       + analysis_counts["bn_bwd_sums"]
                       + tp_counts["bn_bwd_sums"]
                       + span_counts["bn_bwd_sums"]),
             max_abs_err=bn_err,
             **bn_times["bwd_sums"])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5].split(","))
        sys.exit(0)
    if sys.argv[1:2] == ["--span-worker"]:
        span_worker(sys.argv[2], *map(int, sys.argv[3:8]), sys.argv[8].split(","))
        sys.exit(0)
    if sys.argv[1:2] == ["--span-cli-worker"]:
        span_cli_worker(sys.argv[2], sys.argv[3].split())
        sys.exit(0)
    sys.exit(main())

"""Trace a few steps of a hot path and print where the time goes (port of
``litemkd_tpu/cli/profile.py``; the runtime counterpart of ``cli.flops``):

    python -m litemkd_torch.cli.profile --preset student_fc2sup_dist \\
        --pallas_bn --out traces/ [--steps 1] [--path train]
    python -m litemkd_torch.cli.profile --preset tiny --device cpu

``--path``: ``train`` (the student's distillation step; the per-modality
expert is ``--path train --preset expert_trx``), ``eval`` (the episodic
eval forward), ``teacher`` (the MFM's train step) or ``pretrain`` (the
supervised resnet50 step, ``--batch_size`` clips). Each runs on synthetic
data from seed 0, on ``--device`` (cuda by default): one warm-up step, then
``--steps`` steps under ``torch.profiler`` (:func:`~litemkd_torch.utils.
tracing.trace`), whose Chrome trace goes to ``--out``. The summary sums the
card's kernel and copy times by name (on the CPU, the self time of each
op), and names a kernel that one of the port's custom ops launched after
that op (``litemkd::tct_attention``, ``litemkd::bn_sums``,
``litemkd::bn_bwd_sums``).
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

from ..utils.tracing import trace
from .common import add_common_args, add_device_arg, build_config, resolve_device

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def _load(trace_dir: str):
    files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json*")),
                   key=os.path.getmtime)
    if not files:
        return None
    opener = gzip.open if files[-1].endswith(".gz") else open
    with opener(files[-1], "rt") as f:
        return json.load(f)


def _enclosing_ops(ops, points):
    """For each (tid, ts) of ``points``, the name of the innermost op of
    ``ops`` (X events of one process) on that thread that spans ts."""
    by_tid = collections.defaultdict(list)
    for e in ops:
        by_tid[e["tid"]].append(e)
    out = []
    for tid, ts in points:
        inner = None
        for e in by_tid.get(tid, ()):
            if e["ts"] <= ts <= e["ts"] + e["dur"] and (
                    inner is None or e["dur"] <= inner["dur"]):
                inner = e
        out.append(inner["name"] if inner else None)
    return out


def _self_times(ops) -> Dict[str, float]:
    """Exclusive (self) time of each op name, nested ops subtracted."""
    out: Dict[str, float] = collections.Counter()
    by_tid = collections.defaultdict(list)
    for e in ops:
        by_tid[(e.get("pid"), e["tid"])].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            if stack:
                out[stack[-1]["name"]] -= e["dur"]
            out[e["name"]] += e["dur"]
            stack.append(e)
    return out


def summarize(trace_dir: str, top: int = 15) -> Dict[str, float]:
    """Print the op time of the newest trace under ``trace_dir`` and its
    ``top`` ops by name; returns ``{name: µs}``. The card's kernels and
    copies when the trace has any (a kernel launched inside a ``litemkd::``
    op is named ``<op> <kernel>``), else the CPU ops' self times."""
    data = _load(trace_dir)
    if data is None:
        print("no trace files found")
        return {}
    events = [e for e in data.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    if device:
        runtime = {e.get("args", {}).get("correlation"): e for e in events
                   if e.get("cat") in _RUNTIME_CATS}
        launch = [runtime.get(e.get("args", {}).get("correlation"))
                  for e in device]
        owners = _enclosing_ops(
            [e for e in ops if e["name"].startswith("litemkd::")],
            [(r["tid"], r["ts"]) if r else (None, -1) for r in launch])
        buckets: Dict[str, float] = collections.Counter()
        for e, owner in zip(device, owners):
            name = e["name"][:90]
            buckets[f"{owner} {name}" if owner else name] += e["dur"]
        what = f"{len(device)} kernels and copies on the card"
    else:
        buckets = _self_times(ops)
        what = f"{len(ops)} CPU ops, self time"
    total = sum(buckets.values())
    print(f"device op time: {total / 1e3:.3f} ms ({what})")
    for k, d in sorted(buckets.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{d / 1e3:9.3f} ms {100 * d / max(total, 1e-9):5.1f}%  {k}")
    return dict(buckets)


def build_path(path: str, cfg, device, batch_size: int = 8):
    """``run_once()`` for one step of ``path`` on synthetic data from seed
    0, its state on ``device``; each call ends with a host read of a
    metric."""
    from ..data import SyntheticEpisodeSource
    from ..train import to_device
    tpb = cfg.train.tasks_per_batch
    if path == "teacher":
        from ..train import create_mfm_train_state, make_mfm_train_step
        from .train_teacher import SyntheticMultiModalSource
        src = SyntheticMultiModalSource(cfg, n_classes=16, seed=0)
        batch = to_device(src.sample_batch(np.random.default_rng(0), tpb), device)
        state = create_mfm_train_state(cfg, device)
        step = make_mfm_train_step(cfg)
        return lambda: float(step(state, batch)["task_loss"])
    if path == "pretrain":
        from ..train import create_pretrain_state, make_pretrain_step
        t, img = cfg.episode.seq_len, cfg.episode.img_size
        state = create_pretrain_state(cfg, device, 64, (1e-6, 1e-2),
                                      steps_per_epoch=1000, arch="resnet50")
        rng = np.random.default_rng(0)
        clips = torch.from_numpy(rng.integers(
            0, 256, (batch_size, t, img, img, 3), dtype=np.uint8)).to(device)
        labels = (torch.arange(batch_size) % 64).to(device)
        step = make_pretrain_step(cfg)
        return lambda: float(step(state, clips, labels)["loss"])
    from ..train import create_train_state, make_eval_step, make_train_step
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=0)
    batch = to_device(src.sample_batch(np.random.default_rng(0), tpb,
                                       train=path != "eval"), device)
    state = create_train_state(cfg, device)
    if path == "eval":
        model, step = state.model.eval(), make_eval_step(cfg)
        return lambda: float(step(model, batch).sum())
    step = make_train_step(cfg)
    return lambda: float(step(state, batch)["task_loss"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_device_arg(p)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "torchtrace"),
                   help="trace directory (default: torchtrace under the "
                        "temporary directory, $TMPDIR)")
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--tasks_per_batch", type=int, default=16)
    p.add_argument("--micro_batch", type=int, default=4)
    p.add_argument("--path", choices=("train", "eval", "teacher", "pretrain"),
                   default="train",
                   help="which hot path to trace: the student distillation "
                        "train step, the episodic eval forward, the MFM "
                        "fusion-teacher train step, or the supervised "
                        "pretraining step (the per-modality expert step is "
                        "--path train --preset expert_trx)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="pretrain path only: clips per step")
    p.add_argument("--top", type=int, default=15,
                   help="ops listed in the summary")
    args = p.parse_args(argv)
    cfg = build_config(args)
    cfg = cfg.replace(train=cfg.train.__class__(
        **{**cfg.train.__dict__, "tasks_per_batch": args.tasks_per_batch,
           "micro_batch": args.micro_batch}))
    device = resolve_device(args.device)
    from ..ops.dtypes import set_fp32_math
    set_fp32_math()

    run_once = build_path(args.path, cfg, device, args.batch_size)
    run_once()   # warm-up: kernel builds, allocator, cuDNN plans
    with trace(args.out, device):
        for _ in range(args.steps):
            run_once()
    return summarize(args.out, args.top)


if __name__ == "__main__":
    main()

"""Parameters and forward FLOPs of one episode (port of
``litemkd_tpu/cli/flops.py``; the reference's ``flops.py`` with thop):

    python -m litemkd_torch.cli.flops --preset student_fc2sup_dist
    python -m litemkd_torch.cli.flops --preset tiny --device cpu

The student is built and run under ``FakeTensorMode``, tensors that carry
shapes and no data, on ``--device`` (cuda by default), so a full-width
count needs no memory, as the JAX package counts an ``eval_shape`` +
``lower`` without running. Params are the student's parameters that the
forward uses (the ``params`` collection of the JAX package, which flax
builds from the forward: BatchNorm running statistics are buffers and are
not counted, nor is the TCT's ``norm_v``, which the reference layout
carries and no forward reads). FLOPs are counted by ``FlopCounterMode``
(:func:`litemkd_torch.utils.tracing.cost_analysis`): convolutions, matrix
products and the TCT attention's two products, 2 per multiply-add; XLA's
count in the JAX package also counts elementwise work and reductions, so
it is the larger one.
"""
from __future__ import annotations

import argparse

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import Student
from ..utils.tracing import cost_analysis
from .common import add_common_args, add_device_arg, build_config, resolve_device


def count_params(params) -> int:
    return sum(p.numel() for p in params)


def used_params(out, model: torch.nn.Module):
    """The parameters of ``model`` that the autograd graph of ``out`` (a
    tensor or a nested dict of them) reaches: what the JAX package's
    lazily built ``params`` hold. The reference layout also carries the
    TCT's ``norm_v``, which the forward never uses."""
    roots = []

    def collect(x):
        if isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, torch.Tensor) and x.grad_fn is not None:
            roots.append(x.grad_fn)

    collect(out)
    seen, reached, stack = set(), set(), roots
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):
            reached.add(id(fn.variable))
        stack.extend(f for f, _ in fn.next_functions)
    return [p for p in model.parameters() if id(p) in reached]


def _on(model: torch.nn.Module, device) -> torch.nn.Module:
    """``model`` with a tensor of the same shape on ``device`` in place of
    each parameter and buffer (``Module.to`` cannot swap fake tensors, and
    a fake tensor holds no values to move). The model is built on the CPU,
    where its initialisers draw from the CPU generator."""
    for m in model.modules():
        for group in (m._parameters, m._buffers):
            for k, t in group.items():
                if t is not None and t.device.type != device.type:
                    moved = torch.empty(t.shape, dtype=t.dtype, device=device)
                    group[k] = (torch.nn.Parameter(moved, t.requires_grad)
                                if isinstance(t, torch.nn.Parameter) else moved)
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)
    cfg = build_config(args)
    device = resolve_device(args.device)

    ep = cfg.episode
    frame = (ep.seq_len, ep.img_size, ep.img_size, 3)
    with FakeTensorMode():
        model = _on(Student(cfg).eval(), device)
        ctx = torch.empty((ep.n_support, *frame), dtype=torch.uint8, device=device)
        tgt = torch.empty((ep.n_queries(True), *frame), dtype=torch.uint8,
                          device=device)
        labels = torch.arange(ep.way, device=device).repeat_interleave(ep.shot)
        outs = []
        cost = cost_analysis(lambda *a: outs.append(model(*a)), ctx, labels, tgt)
        params = count_params(used_params(outs[0], model))
    flops = cost["flops"]

    print(f"model: {cfg.model.backbone} + {cfg.model.classifier}")
    print(f"episode: {ep.way}-way {ep.shot}-shot, {ep.n_queries(True)} queries, "
          f"{ep.seq_len}x{ep.img_size}px")
    print(f"params: {params / 1e6:.2f} M")
    print(f"forward cost: {flops / 1e9:.2f} GFLOPs/episode "
          "(FlopCounterMode: convolutions, matrix and attention products)")
    for op, n in sorted(cost["by_op"].items(), key=lambda kv: -kv[1]):
        print(f"  {op}: {n / 1e9:.2f} GFLOPs")
    return {"params": params, "gflops": flops / 1e9}


if __name__ == "__main__":
    main()

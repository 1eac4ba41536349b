"""Profiling helpers (port of ``litemkd_tpu/utils/tracing.py``): the FLOPs of
one call of a function, and a trace of the work of a block.

:func:`cost_analysis` counts through ``torch.utils.flop_counter``'s
``FlopCounterMode``, which counts the products of matrix multiplications,
convolutions and attention (2 per multiply-add), not elementwise work or
reductions; the JAX package's XLA ``cost_analysis`` counts those as well,
so its number is the larger one. The mode does not see into a custom op,
so this module gives it the formula of ``litemkd::tct_attention``: the two
products of the TCT attention, scores = q_k·class_kᵀ and proto =
attn·class_v, 2·E·Q·W·U·(S·U)·dk each, which XLA counts inside
``tct_attention_xla``. The BN-moment ops (``litemkd::bn_sums``,
``litemkd::bn_bwd_sums``) are column sums, and get no formula: the mode
counts no reduction, so the kernel path and the plain path (whose sums it
does not count either) give the same number.

:func:`trace` records ``torch.profiler`` activity (the CPU's always, the
card's when the work runs there) and writes a Chrome trace; it is a no-op
for ``log_dir=None``. Unlike the JAX package's ``trace`` it does not
swallow a profiler error.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import torch
from torch.utils.flop_counter import (FlopCounterMode, flop_registry,
                                      register_flop_formula)

from ..ops import tct_attention as _tct   # registers litemkd::tct_attention


def tct_attention_flops(q_k_shape, q_v_shape, class_k_shape, class_v_shape,
                        *args, out_shape=None, **kwargs) -> int:
    """Products of one ``litemkd::tct_attention`` call: q_k (E, Q, U, dk)
    against class_k (E, W, S, U, dk) for the (E, Q, W, U, S·U) scores, and
    the scores against class_v for the prototypes."""
    e, q, u, dk = q_k_shape
    w, s = class_k_shape[1], class_k_shape[2]
    return 2 * 2 * e * q * w * u * (s * u) * dk


if torch.ops.litemkd.tct_attention not in flop_registry:
    register_flop_formula(torch.ops.litemkd.tct_attention)(tct_attention_flops)


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """``{"flops": ...}`` for one call of ``fn(*example_args)``, and the
    count of each op under ``"by_op"``. Call it under a
    ``FakeTensorMode`` (with fake arguments and a module built in it) to
    count a full-width model without memory."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*example_args)
    by_op = {str(k): float(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_op": by_op}


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """``with trace('/tmp/torchtrace') as prof: step(...)``: records the
    CPU's activity and, when ``device`` is a CUDA device (by default when a
    card is present), the card's; on leaving, writes
    ``<log_dir>/<host>_<pid>.<ns>.pt.trace.json`` (TensorBoard's PyTorch
    profiler and Perfetto read it) and yields the ``torch.profiler``
    object. ``log_dir=None`` records nothing and yields None. A profiler
    that fails raises."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()

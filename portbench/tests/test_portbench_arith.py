"""The benchmark's arithmetic without a card: busy union and idle gaps,
kernel time by launching op, the TCT's operations and bytes, the readers
on a synthetic trace, the open-loop schedule and lateness, percentiles,
the JAX-import check, and the frozen FLOP counts."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import check, flops, harness, rooflines, spec, trace
from portbench.drivers import serve_open_loop as srv
from portbench.reference.common import Dropout, tct_logits

ROOT = Path(__file__).resolve().parents[2]


def ev(name, a, b, *ops):
    return trace.DeviceEvent(name, a, b, tuple(ops))


def test_busy_union_span_and_gaps():
    busy, span, gaps = trace.busy_union([(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)])
    assert (busy, span) == (12 + 11 + 1, 41)
    assert gaps == [(12, 20), (31, 40)]
    assert trace.busy_union([]) == (0.0, 0.0, [])


def test_idle_gaps_named_by_the_op_that_ended_them_and_summary():
    dev = [ev("k1", 0, 10, "aten::convolution"), ev("k2", 15, 20, "aten::mm"),
           ev("nccl_allreduce", 30, 35, "c10d::allreduce_"), ev("k3", 36, 40)]
    s = trace.summarize(dev, [trace.OpCall(trace.TCT_OP, [[1, 5, 28, 1152], [1, 5, 28, 1152],
                                                         [1, 5, 5, 28, 1152]] * 1, 2.0)], 2)
    assert s["busy_s"] == pytest.approx(24e-6) and s["span_s"] == pytest.approx(40e-6)
    assert dict((k, v) for k, v in s["idle_gaps"]) == pytest.approx(
        {"aten::mm": 5e-6, "c10d::allreduce_": 10e-6, "(no host op)": 1e-6})
    assert s["unlinked"] == 1
    assert trace.seconds_under(s, ["aten::convolution", "aten::mm"]) == pytest.approx(15e-6)
    assert trace.seconds_named(s, "nccl") == pytest.approx(5e-6)


def test_kernels_by_name_come_from_the_device_only_profile():
    hosted = [ev("k1", 0, 10, "aten::convolution"),
              ev("nccl_allreduce", 10, 60, "c10d::allreduce_")]
    quiet = [ev("k1", 0, 10), ev("nccl_allreduce", 10, 13)]
    s = trace.summarize(hosted, [], 1, quiet)
    assert trace.seconds_named(s, "nccl") == pytest.approx(3e-6)
    assert trace.seconds_under(s, ["c10d::allreduce_"]) == pytest.approx(50e-6)


def test_tct_operations_match_the_flop_counter_and_bytes_are_counted_once():
    e, q, w, sh, t, d, dk = 2, 3, 5, 5, 4, 16, 8
    P = {f"h.{n}.weight": torch.randn(dk, 2 * d) for n in ("k_linear", "v_linear")}
    P.update({f"h.{n}.bias": torch.zeros(dk) for n in ("k_linear", "v_linear")})
    P.update({"h.norm_k.weight": torch.ones(dk), "h.norm_k.bias": torch.zeros(dk)})
    labels = torch.arange(w).repeat(sh)[None].expand(e, -1)
    support, queries = torch.randn(e, w * sh, t, d), torch.randn(e, q, t, d)
    u = t * (t - 1) // 2
    count = FlopCounterMode(display=False)
    with count:
        tct_logits(P, "h", support, labels, queries, w, sh, Dropout(0.0, None))
    linears = 2 * 2 * (e * (w * sh + q) * u * 2 * d * dk)
    qk, ck = (e, q, u, dk), (e, w, sh, u, dk)
    assert count.get_total_flops() - linears == rooflines.tct_ops(qk, ck)
    assert rooflines.tct_ops(qk, ck) == 4 * e * q * w * u * sh * u * dk
    assert rooflines.tct_bytes(qk, ck) == 4 * (2 * e * q * u * dk + 2 * e * w * sh * u * dk
                                               + e * q * w)
    from litemkd_torch.utils.tracing import tct_attention_flops
    assert tct_attention_flops(qk, qk, ck, ck) == rooflines.tct_ops(qk, ck)


def test_readers_on_a_synthetic_trace():
    cell = spec.load_cell(ROOT, "student.train")
    conv = ev("conv", 0, 600, "aten::cudnn_convolution", "aten::convolution")
    tct = ev("tct_kernel", 700, 1000, "litemkd::tct_attention")
    shapes = [[4, 25, 28, 1152]] * 2 + [[4, 5, 5, 28, 1152]] * 2
    s = trace.summarize([conv, tct], [trace.OpCall(trace.TCT_OP, shapes, 300.0)], 2)
    ctx = {"cell": cell, "trace": s, "notes": [],
           "outcome": {"device": {"platform": "gpu"}, "units": 10, "window_s": 6.5,
                       "served": 20, "service_s": 0.01}}
    read = lambda n: spec.layer_reader(ROOT, n).read(ctx)
    assert read("device_idle.train") == pytest.approx(100 * (1 - 450e-6 / 0.65))
    assert read("device_idle.serve") == pytest.approx(10.0)   # 450 of 500 us a request
    assert read("trunk_ms.train") == pytest.approx(0.3)
    assert read("tct_roofline.train") == pytest.approx(
        100 * rooflines.tct_bound_s(shapes[0], shapes[2]) / 300e-6)
    flops_ = cell.config["flops"]["train_step"]
    assert read("mfu.train") == pytest.approx(100 * rooflines.least_seconds(flops_) / 0.65)
    assert 0 < read("mfu.train") < 100


def test_arrivals_are_the_same_for_every_seed_and_inside_the_window():
    a = srv.arrivals(72.0, 10.0, 20240817)
    assert a[0] == 0 and a[-1] < 10.0 and np.all(np.diff(a) > 0)
    assert abs(len(a) - 720) < 4 * math.sqrt(720)
    assert np.array_equal(a, srv.arrivals(72.0, 10.0, 20240817))


def test_lateness_latency_backlog_and_failures():
    out = torch.zeros(1, 5, 5)
    recs = [(0.0, 0.001, 0.011, out),      # idle at arrival: late 1 ms
            (0.005, 0.011, 0.021, out),    # queued behind the first: not lateness
            (0.030, 0.030, 0.040, torch.full((1, 5, 5), math.nan)),   # non-finite
            (0.095, math.inf, math.inf, None)]   # never answered
    st = srv.stats(recs, 0.1)
    assert st["latencies_ms"][:2] == pytest.approx([11.0, 16.0])
    assert st["latencies_ms"][2:] == [math.inf, math.inf] and st["failed"] == 2
    assert st["late_max_s"] == pytest.approx(0.001) and st["backlog"] == 1
    assert harness.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    assert harness.percentile([1.0, math.inf], 95) == math.inf


def test_jax_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["litemkd_torch", "litemkd_torch.ops", "jaxtyping",
                                      "flaxen", "torch"]) == []
    assert harness.forbidden_modules(["litemkd_tpu.models", "jax.numpy", "jaxlib",
                                      "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                         "litemkd_tpu"]


def test_leaf_numbers():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "q": torch.full((4,), 1e-9)}
    assert check.kept(ref) == ["a", "b"]
    g = check.leaf_gaps({"a": 2 * torch.ones(4), "b": ref["b"]}, ref, ["a", "b"])
    assert g == pytest.approx({"a": 1.0, "b": 0.0})   # |4 - 2| / max(2, median 2)
    assert check.cos_gap({"a": torch.zeros(4)}, ref, ["a"]) == 1.0
    assert check.cos_gap(ref, ref, ["a", "b"]) == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("name", ["student_fc2sup_dist", "mfm_teacher"])
def test_frozen_flop_counts_recomputed_from_the_reference(name):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    assert flops.counts(cfg) == cfg["flops"]


def test_fake_count_equals_a_real_count_at_tiny_size():
    from portbench.tests import tiny
    from portbench.families import student
    fake = student.flop_counts(tiny.STUDENT)
    real = student.flop_counts(tiny.STUDENT, fake=False)
    assert fake == real and fake["train_step"]["bf16"] > 0

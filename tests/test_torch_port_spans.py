"""The program's spans (``litemkd_torch.utils.tracing.span``) and the
attribution of a profile to them (``attribute``), on the CPU:

- off (no profiler) a span is one shared no-op that enters no record
  function; under a CPU profile it is a ``litemkd/<name>`` range around
  its ops, not a user annotation;
- the tiny student's and MFM's train steps and the scorer name their
  layers, and give the same numbers with the profiler as without it; the
  scorer exported by ``torch.export`` holds no profiler node;
- the attribution on synthetic records: backward kernels under their
  forward op's span, the ``backward`` fallback, idle gaps split by time
  overlap, syncs counted once per op, a device-typed user annotation
  dropped, host self time where the trace has no device events;
- ``cli.profile`` prints the grouping by span."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from litemkd_torch import preset
from litemkd_torch.cli import profile as profile_cli
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.models import BatchedStudent, init_student_
from litemkd_torch.tools import aot
from litemkd_torch.train import (create_mfm_train_state, create_train_state,
                                 make_mfm_train_step, make_train_step, to_device)
from litemkd_torch.utils import tracing
from litemkd_torch.utils.tracing import OUTSIDE, DeviceOp, HostOp

STUDENT_SPANS = ("trunk", "head", "teacher", "loss", "backward", "optimizer")
MFM_SPANS = ("encoders", "head", "loss", "backward", "optimizer")


def _cfg(micro_batch=0, tasks=2):
    cfg = preset("tiny")
    return cfg.replace(train=dataclasses.replace(cfg.train, tasks_per_batch=tasks,
                                                 micro_batch=micro_batch))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _chain_names(op):
    return [o.name for o in tracing.chain(op)]


def _spans_enclosed_by(host, outer, names):
    for name in names:
        recs = [o for o in host if o.name == tracing.SPAN_PREFIX + name]
        assert recs, name
        assert all(tracing.SPAN_PREFIX + outer in _chain_names(o)[1:] for o in recs), name


# ---------------------------------------------------------------------------
# the span itself
# ---------------------------------------------------------------------------

def test_span_off_is_one_shared_noop_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record function was entered")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("trunk"), tracing.span("head")
    assert a is b
    with a:
        with b:
            torch.ones(2).add_(1)


def test_span_under_a_cpu_profile_encloses_its_ops():
    def work():
        with tracing.span("outer"):
            with tracing.span("inner"):
                y = torch.ones(4) + 1
            return y * 2

    _, prof = _profiled(work)
    host, device = tracing.profile_records(prof)
    assert device == []
    add = next(o for o in host if o.name == "aten::add")
    mul = next(o for o in host if o.name == "aten::mul")
    assert _chain_names(add)[1:3] == ["litemkd/inner", "litemkd/outer"]
    assert _chain_names(mul)[1:] == ["litemkd/outer"]
    ranges = [e for e in prof.events() if e.name.startswith(tracing.SPAN_PREFIX)]
    assert {e.name for e in ranges} == {"litemkd/inner", "litemkd/outer"}
    assert not any(e.is_user_annotation for e in ranges)


# ---------------------------------------------------------------------------
# the train steps and the scorer
# ---------------------------------------------------------------------------

def _student_run(cfg, profiled):
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=0)
    batch = to_device(src.sample_batch(np.random.default_rng(0), cfg.train.tasks_per_batch),
                      "cpu")
    state = create_train_state(cfg, "cpu")
    step = make_train_step(cfg)
    if not profiled:
        return step(state, batch), state, None
    metrics, prof = _profiled(lambda: step(state, batch))
    return metrics, state, prof


@pytest.mark.parametrize("micro_batch", [0, 1])
def test_student_step_names_its_layers_and_changes_no_number(micro_batch):
    cfg = _cfg(micro_batch)
    want, plain, _ = _student_run(cfg, False)
    got, traced, prof = _student_run(cfg, True)
    assert torch.equal(got["task_loss"], want["task_loss"])
    for (n, p), q in zip(traced.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), n
        assert (p.grad is None) == (q.grad is None) and (
            p.grad is None or torch.equal(p.grad, q.grad)), n
    host, device = tracing.profile_records(prof)
    _spans_enclosed_by(host, "step", STUDENT_SPANS)
    rep = tracing.attribute(host, device)
    assert set(STUDENT_SPANS) <= set(rep["time_us"])
    assert tracing.shares(rep)["backward_linked_pct"] > 90
    assert rep["time_us"].get(OUTSIDE, 0.0) == 0.0


def test_mfm_step_names_its_encoders_and_head():
    from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
    cfg = _cfg()
    src = SyntheticMultiModalSource(cfg, n_classes=16, seed=0)
    batch = to_device(src.sample_batch(np.random.default_rng(0), 2), "cpu")
    plain, traced = create_mfm_train_state(cfg, "cpu"), create_mfm_train_state(cfg, "cpu")
    step = make_mfm_train_step(cfg)
    want = step(plain, batch)
    got, prof = _profiled(lambda: step(traced, batch))
    assert torch.equal(got["task_loss"], want["task_loss"])
    for p, q in zip(traced.model.parameters(), plain.model.parameters()):
        assert torch.equal(p, q)
    host, device = tracing.profile_records(prof)
    _spans_enclosed_by(host, "step", MFM_SPANS)
    rep = tracing.attribute(host, device)
    assert rep["time_us"]["encoders"] > rep["time_us"]["loss"]
    assert tracing.shares(rep)["backward_linked_pct"] > 90


def _tiny_scorer():
    cfg = _cfg()
    model = BatchedStudent(cfg)
    init_student_(model, torch.Generator().manual_seed(4))
    ep = cfg.episode
    frame = (ep.seq_len, ep.img_size, ep.img_size, 3)
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(rng.integers(0, 256, (1, ep.n_support, *frame), dtype=np.uint8)),
            torch.arange(ep.way).repeat(ep.shot)[None],
            torch.from_numpy(rng.integers(0, 256, (1, ep.n_queries(False), *frame),
                                          dtype=np.uint8)))
    return cfg, model, args


def test_scorer_span_encloses_the_model_and_changes_no_logit():
    cfg, model, args = _tiny_scorer()
    scorer = aot.make_serving_fn(cfg, model)
    with torch.inference_mode():
        want = scorer(*args)
        got, prof = _profiled(lambda: scorer(*args))
    assert torch.equal(got, want)
    host, _ = tracing.profile_records(prof)
    _spans_enclosed_by(host, "score", ("trunk", "head"))


def test_exported_scorer_has_no_profiler_node(tmp_path):
    cfg, model, args = _tiny_scorer()
    path = str(tmp_path / "tiny.litemkd")
    aot.export_serving_artifact(cfg, model, path, "cpu", episodes=1)
    program = aot.load_program(path)[0]
    targets = [str(n.target) for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    with torch.inference_mode():
        want = aot.make_serving_fn(cfg, model)(*args)
    torch.testing.assert_close(aot.load_serving_artifact(path)[0](*args), want,
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the attribution, on synthetic records (µs; thread 1 the main thread, 2
# the autograd engine's device thread)
# ---------------------------------------------------------------------------

def _op(name, thread, a, b, parent=None, seq=-1, fwd_thread=0):
    return HostOp(name, thread, a, b, parent, seq, fwd_thread)


def _launch(parent, at):
    return _op("cudaLaunchKernel", parent.thread, at, at + 1, parent)


def test_backward_kernels_go_to_their_forward_ops_span():
    step = _op("litemkd/step", 1, 0, 100)
    head = _op("litemkd/head", 1, 0, 10, step)
    addmm = _op("aten::addmm", 1, 1, 9, head, seq=4)
    bwd = _op("litemkd/backward", 1, 20, 60, step)
    node = _op(tracing.BACKWARD_NODE + "AddmmBackward0", 2, 25, 40, seq=4, fwd_thread=1)
    mm = _op("aten::mm", 2, 26, 39, node)
    host = [step, head, addmm, bwd, node, mm]
    device = [DeviceOp("gemm_fwd", 2, 8, _launch(addmm, 2)),
              DeviceOp("gemm_bwd", 27, 35, _launch(mm, 27))]
    rep = tracing.attribute(host + [d.launch for d in device], device)
    assert rep["time_us"] == {"head": 6 + 8}
    assert rep["backward_linked_us"] == 8 and rep["backward_left_us"] == 0
    assert tracing.shares(rep)["backward_linked_pct"] == 100


def test_unlinked_backward_kernels_fall_back_to_backward_or_outside():
    step = _op("litemkd/step", 1, 0, 100)
    bwd = _op("litemkd/backward", 1, 20, 60, step)
    acc = _op(tracing.BACKWARD_NODE + "torch::autograd::AccumulateGrad", 2, 30, 40)
    add = _op("aten::add_", 2, 31, 39, acc)
    late = _op("aten::add_", 2, 70, 80)      # after the backward call closed
    device = [DeviceOp("acc", 32, 36, _launch(add, 32)),
              DeviceOp("late", 72, 75, _launch(late, 72))]
    rep = tracing.attribute([step, bwd, acc, add, late] + [d.launch for d in device], device)
    assert rep["time_us"] == {"backward": 4, OUTSIDE: 3}
    assert rep["backward_left_us"] == 4 and rep["backward_linked_us"] == 0


def test_idle_gaps_split_by_what_the_launching_thread_was_inside():
    trunk = _op("litemkd/trunk", 1, 0, 15)
    conv = _op("aten::convolution", 1, 1, 5, trunk)
    loss = _op("litemkd/loss", 1, 20, 35)
    mul = _op("aten::mul", 1, 24, 26, loss)
    device = [DeviceOp("conv", 2, 10, _launch(conv, 2)),
              DeviceOp("mul", 30, 40, _launch(mul, 25))]
    rep = tracing.attribute([trunk, conv, loss, mul] + [d.launch for d in device], device)
    assert rep["idle_us"] == {"trunk": 5, OUTSIDE: 5, "loss": 10}
    assert (rep["busy_us"], rep["window_us"], rep["idle_us_total"]) == (18, 38, 20)
    assert tracing.shares(rep)["idle_in_program_pct"] == 75


def test_syncs_count_once_per_op_in_their_span():
    step = _op("litemkd/step", 1, 0, 100)
    loss = _op("litemkd/loss", 1, 0, 30, step)
    item = _op(tracing.SYNC_OP, 1, 5, 15, loss)
    wait = _op("cudaStreamSynchronize", 1, 10, 14, item)
    copy_op = _op("aten::copy_", 1, 16, 25, loss)
    copy_call = _op("cudaMemcpyAsync", 1, 17, 18, copy_op)
    copy_wait = _op("cudaStreamSynchronize", 1, 19, 24, copy_op)
    opt = _op("litemkd/optimizer", 1, 40, 60, step)
    loose = _op("cudaDeviceSynchronize", 99, 45, 50)    # no op around it
    host = [step, loss, item, wait, copy_op, copy_call, copy_wait, opt, loose]
    device = [DeviceOp("Memcpy DtoH (Device -> Pageable)", 18, 19, copy_call)]
    rep = tracing.attribute(host, device)
    assert rep["syncs"] == {"loss": 2, "optimizer": 1}
    assert rep["sync_ops"] == {"loss: aten::_local_scalar_dense": 1, "loss: aten::copy_": 1,
                               "optimizer: cudaDeviceSynchronize": 1}


def test_a_device_typed_user_annotation_is_no_device_event():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, eid, a, b, device_type=cpu, parent=None, annotation=False, linked=0):
        return SimpleNamespace(name=name, id=eid, thread=1, time_range=SimpleNamespace(
            start=a, end=b), cpu_parent=parent, sequence_nr=-1, fwd_thread=0,
            device_type=device_type, is_user_annotation=annotation,
            linked_correlation_id=linked)

    span = ev("litemkd/head", 1, 0, 20)
    op = ev("aten::mm", 2, 1, 10, parent=span)
    call = ev("cudaLaunchKernel", 7, 2, 3, parent=op)
    kernel = ev("gemm", 7, 4, 9, cuda)
    annotation = ev("litemkd/head", 1, 4, 9, cuda, annotation=True)
    prof = SimpleNamespace(events=lambda: [span, op, call, kernel, annotation])
    host, device = tracing.profile_records(prof)
    assert [d.name for d in device] == ["gemm"]
    assert device[0].launch.name == "cudaLaunchKernel"
    assert _chain_names(device[0].launch) == ["cudaLaunchKernel", "aten::mm", "litemkd/head"]
    assert tracing.attribute(host, device)["time_us"] == {"head": 5}


def test_without_device_events_host_self_time_takes_their_place():
    trunk = _op("litemkd/trunk", 1, 0, 20)
    conv = _op("aten::convolution", 1, 0, 10, trunk)
    inner = _op("aten::cudnn_convolution", 1, 2, 8, conv)
    loose = _op("aten::add", 1, 30, 33)
    rep = tracing.attribute([trunk, conv, inner, loose], [])
    assert rep["what"] == "host self time"
    assert rep["time_us"] == {"trunk": 10, OUTSIDE: 3}
    assert rep["idle_us"] == {} and rep["window_us"] == 0


# ---------------------------------------------------------------------------
# cli.profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,spans", [("train", STUDENT_SPANS), ("teacher", MFM_SPANS)])
def test_profile_groups_the_trace_by_program_span(path, spans, tmp_path, capsys):
    profile_cli.main(["--preset", "tiny", "--device", "cpu", "--path", path,
                      "--steps", "1", "--tasks_per_batch", "2", "--micro_batch", "0",
                      "--out", str(tmp_path / "trace")])
    printed = capsys.readouterr().out
    block = printed[printed.index("by program span, per step (host self time"):]
    rows = {line.split("  ")[-1] for line in block.splitlines()[1:]}
    assert set(spans) <= rows
    assert "shares (%): outside" in block

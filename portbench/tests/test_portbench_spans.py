"""The program's spans as the benchmark reads them, without a card: the
attribution of ``portbench.spans`` on synthetic records (µs; thread 1 the
main thread, 2 the autograd engine's device thread), the
``optimizer_span_ms.train`` reader on a synthetic summary, and
``portbench.span_report`` on tiny cells on the CPU."""
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import span_report, spans, spec, trace
from portbench.spans import OUTSIDE, Kernel, Op
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def ev(name, a, b, *ops):
    return trace.DeviceEvent(name, a, b, tuple(ops))


def test_optimizer_span_reader_counts_the_kernels_whose_innermost_span_it_is():
    cell = spec.load_cell(ROOT, "student.train")
    step = "litemkd/step"
    kernels = [
        ev("foreach_add", 0, 300, "aten::_foreach_add_", "Optimizer.step#SGD.step",
           "litemkd/optimizer", step),
        # the device-typed copy of a host range, named as its own first op
        ev("Optimizer.step#SGD.step", 0, 300, "Optimizer.step#SGD.step",
           "litemkd/optimizer", step),
        ev("conv", 400, 1000, "aten::cudnn_convolution", "litemkd/trunk", step),
        ev("sum", 1000, 1100, "aten::sum", step),
    ]
    ctx = {"cell": cell, "trace": trace.summarize(kernels, [], 2), "notes": [],
           "outcome": {"device": {"platform": "gpu"}, "units": 10, "window_s": 6.5}}
    assert spec.layer_reader(ROOT, "optimizer_span_ms.train").read(ctx) == \
        pytest.approx(0.15)
    ctx["trace"] = trace.summarize(kernels[2:], [], 2)    # a program without the span
    assert spec.layer_reader(ROOT, "optimizer_span_ms.train").read(ctx) is None


@pytest.mark.parametrize("cell,spans", [
    ("tiny.train", {"trunk", "head", "teacher", "loss", "backward", "optimizer"}),
    ("tiny.serve", {"trunk", "head"}),
])
def test_span_report_of_a_tiny_cell(tmp_path, cell, spans):
    root = tiny.write(tmp_path, (cell,))
    rep = span_report.report(root, cell, 2**31 + 11, 2, torch.device("cpu"))
    assert rep["units"] == 2 and rep["what"] == "host self time"
    assert spans <= set(rep["time_us"])
    assert rep["outside_pct"] < 50


def _launch(parent, at):
    return Op("cudaLaunchKernel", parent.thread, at, at + 1, parent)


def test_backward_kernels_go_to_their_forward_ops_span_by_sequence_number():
    step = Op("litemkd/step", 1, 0, 100)
    head = Op("litemkd/head", 1, 0, 10, step)
    addmm = Op("aten::addmm", 1, 1, 9, head, seq=4)
    other = Op("aten::addmm", 1, 11, 19, step, seq=5)   # a forward op under step alone
    bwd = Op("litemkd/backward", 1, 20, 60, step)
    node = Op(spans.BACKWARD_NODE + "AddmmBackward0", 2, 25, 40, seq=4, fwd_thread=1)
    mm = Op("aten::mm", 2, 26, 39, node)
    device = [Kernel("gemm_fwd", 2, 8, _launch(addmm, 2)),
              Kernel("gemm_bwd", 27, 35, _launch(mm, 27))]
    rep = spans.attribute([step, head, addmm, other, bwd, node, mm]
                          + [d.launch for d in device], device)
    assert rep["time_us"] == {"head": 6 + 8}
    assert rep["backward_linked_us"] == 8 and rep["backward_left_us"] == 0
    assert spans.shares(rep)["backward_linked_pct"] == 100


def test_unlinked_backward_kernels_fall_back_to_backward_or_outside():
    step = Op("litemkd/step", 1, 0, 100)
    bwd = Op("litemkd/backward", 1, 20, 60, step)
    acc = Op(spans.BACKWARD_NODE + "torch::autograd::AccumulateGrad", 2, 30, 40)
    add = Op("aten::add_", 2, 31, 39, acc)
    late = Op("aten::add_", 2, 70, 80)      # after the backward call closed
    device = [Kernel("acc", 32, 36, _launch(add, 32)),
              Kernel("late", 72, 75, _launch(late, 72))]
    rep = spans.attribute([step, bwd, acc, add, late] + [d.launch for d in device], device)
    assert rep["time_us"] == {"backward": 4, OUTSIDE: 3}
    assert rep["backward_left_us"] == 4 and rep["backward_linked_us"] == 0


def test_idle_gaps_split_by_what_the_launching_thread_was_inside():
    trunk = Op("litemkd/trunk", 1, 0, 15)
    conv = Op("aten::convolution", 1, 1, 5, trunk)
    loss = Op("litemkd/loss", 1, 20, 35)
    mul = Op("aten::mul", 1, 24, 26, loss)
    device = [Kernel("conv", 2, 10, _launch(conv, 2)),
              Kernel("mul", 30, 40, _launch(mul, 25))]
    rep = spans.attribute([trunk, conv, loss, mul] + [d.launch for d in device], device)
    assert rep["idle_us"] == {"trunk": 5, OUTSIDE: 5, "loss": 10}
    assert (rep["busy_us"], rep["window_us"], rep["idle_us_total"]) == (18, 38, 20)
    assert spans.shares(rep)["idle_in_program_pct"] == 75


def test_syncs_count_once_per_op_in_their_span():
    step = Op("litemkd/step", 1, 0, 100)
    loss = Op("litemkd/loss", 1, 0, 30, step)
    item = Op(spans.SYNC_OP, 1, 5, 15, loss)
    wait = Op("cudaStreamSynchronize", 1, 10, 14, item)
    copy_op = Op("aten::copy_", 1, 16, 25, loss)
    copy_call = Op("cudaMemcpyAsync", 1, 17, 18, copy_op)
    copy_wait = Op("cudaStreamSynchronize", 1, 19, 24, copy_op)
    opt = Op("litemkd/optimizer", 1, 40, 60, step)
    loose = Op("cudaDeviceSynchronize", 99, 45, 50)    # no op around it
    host = [step, loss, item, wait, copy_op, copy_call, copy_wait, opt, loose]
    device = [Kernel("Memcpy DtoH (Device -> Pageable)", 18, 19, copy_call)]
    rep = spans.attribute(host, device)
    assert rep["syncs"] == {"loss": 2, "optimizer": 1}
    assert rep["sync_ops"] == {"loss: aten::_local_scalar_dense": 1, "loss: aten::copy_": 1,
                               "optimizer: cudaDeviceSynchronize": 1}


def test_records_drop_a_device_typed_user_annotation():
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
    host, device = spans.records(prof)
    assert [d.name for d in device] == ["gemm"]
    assert [o.name for o in spans.chain(device[0].launch)] == [
        "cudaLaunchKernel", "aten::mm", "litemkd/head"]
    assert spans.attribute(host, device)["time_us"] == {"head": 5}

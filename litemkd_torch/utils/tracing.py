"""Profiling helpers (port of ``litemkd_tpu/utils/tracing.py``): the FLOPs of
one call of a function, a trace of the work of a block, the program's
spans, and the attribution of a trace's device time and idle gaps to them.

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

:func:`span` names a layer of the program in the profiler's trace
(``litemkd/<name>``) while a profiler runs, and costs one check otherwise.
The spans are events of the profiler that records the card, so they share
the device trace's clock. :func:`profile_records` flattens a profile into
host and device records and :func:`attribute` hands every device event,
idle gap and host-card synchronisation of them to one span (see there);
``cli.profile`` prints both. The benchmark under ``portbench/`` keeps its
own copy of the attribution, so a change here moves none of its metrics.

The models and train steps import this module, so it imports nothing of
the package when it is imported: the TCT formula is registered on the
first :func:`cost_analysis`.
"""
from __future__ import annotations

import bisect
import contextlib
import os
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

SPAN_PREFIX = "litemkd/"
OUTSIDE = "(outside the program)"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
RUNTIME = ("cuda", "cu")        # CUDA runtime and driver API calls
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
SYNC_OP = "aten::_local_scalar_dense"
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("trunk"): ...``: while a profiler runs, a
    ``litemkd/<name>`` range of the trace around the block; otherwise one
    shared no-op context, so a span off costs a check and no allocation.
    The range is a plain record-function scope, not a user annotation, so
    the profiler adds no device-typed copy of it beside the kernels. Under
    ``torch.export`` (no profiler) a span leaves nothing in the graph."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def tct_attention_flops(q_k_shape, q_v_shape, class_k_shape, class_v_shape,
                        *args, out_shape=None, **kwargs) -> int:
    """Products of one ``litemkd::tct_attention`` call: q_k (E, Q, U, dk)
    against class_k (E, W, S, U, dk) for the (E, Q, W, U, S·U) scores, and
    the scores against class_v for the prototypes."""
    e, q, u, dk = q_k_shape
    w, s = class_k_shape[1], class_k_shape[2]
    return 2 * 2 * e * q * w * u * (s * u) * dk


def _register_tct_formula() -> None:
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from ..ops import tct_attention as _tct   # registers litemkd::tct_attention
    if torch.ops.litemkd.tct_attention not in flop_registry:
        register_flop_formula(torch.ops.litemkd.tct_attention)(tct_attention_flops)


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """``{"flops": ...}`` for one call of ``fn(*example_args)``, and the
    count of each op under ``"by_op"``. Call it under a
    ``FakeTensorMode`` (with fake arguments and a module built in it) to
    count a full-width model without memory."""
    from torch.utils.flop_counter import FlopCounterMode
    _register_tct_formula()
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


@dataclass(eq=False)
class HostOp:
    """A host op, span or runtime call of one thread of a profile, with the
    op around it (``parent``). ``seq`` is the autograd sequence number the
    profiler gave the op (-1 for none) and ``fwd_thread`` a backward node's
    forward thread (0 for the forward ops themselves): a backward node has
    the ``seq`` and, as ``fwd_thread``, the ``thread`` of the forward op
    that made it."""
    name: str
    thread: int
    start_us: float
    end_us: float
    parent: Optional["HostOp"] = None
    seq: int = -1
    fwd_thread: int = 0


@dataclass(eq=False)
class DeviceOp:
    """A kernel, copy or set of the card, and the host record that launched
    it: the runtime call (its parent, the op around the call), or the op
    the profiler linked it to where no call is recorded."""
    name: str
    start_us: float
    end_us: float
    launch: Optional[HostOp] = None


def chain(op: Optional[HostOp]) -> Iterator[HostOp]:
    """``op`` and the ops around it, from the innermost outwards."""
    while op is not None:
        yield op
        op = op.parent


def _innermost_span(op: Optional[HostOp]) -> Optional[str]:
    for o in chain(op):
        if o.name.startswith(SPAN_PREFIX):
            return o.name[len(SPAN_PREFIX):]
    return None


def _forward_spans(host: Sequence[HostOp]) -> Dict[Tuple[int, int], str]:
    """(thread, autograd sequence number) of every forward op under a span
    → that span (innermost): the key a backward node finds its forward
    op's span by."""
    out: Dict[Tuple[int, int], str] = {}
    for o in host:
        if o.seq >= 0 and o.fwd_thread == 0 and not o.name.startswith(BACKWARD_NODE):
            s = _innermost_span(o)
            if s is not None:
                out.setdefault((o.thread, o.seq), s)
    return out


def _own_label(op: Optional[HostOp], fwd) -> Tuple[Optional[str], bool]:
    """(span, through a backward node) of the work launched from ``op``: the
    first, from ``op`` outwards, of a backward node whose forward op ran
    under a span (that span) and a span."""
    for o in chain(op):
        if o.name.startswith(BACKWARD_NODE):
            s = fwd.get((o.fwd_thread, o.seq))
            if s is not None:
                return s, True
        if o.name.startswith(SPAN_PREFIX):
            return o.name[len(SPAN_PREFIX):], False
    return None, False


class _Timeline:
    """Nested intervals of one thread, each with a label; ``at(t)`` is the
    innermost one open at ``t`` (bisect, then out through the parents)."""

    def __init__(self, items: List[Tuple[float, float, str]]):
        self.items = sorted(items, key=lambda x: (x[0], -x[1]))
        self.starts = [a for a, _, _ in self.items]
        self.points = sorted({p for a, b, _ in self.items for p in (a, b)})
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (a, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> Optional[Tuple[str, float]]:
        """(label, length) of the innermost interval open at ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        if i < 0:
            return None
        a, b, label = self.items[i]
        return label, b - a

    def inside(self, a: float, b: float) -> List[float]:
        return self.points[bisect.bisect_right(self.points, a):
                           bisect.bisect_left(self.points, b)]


class _Spans:
    """Where a host record's work goes: its own chain first (a backward
    node's forward span, or the innermost span), else ``backward`` if the
    program's backward call was open at that time, else outside the
    program; and what each thread was inside at a given time, for the idle
    gaps."""

    def __init__(self, host: Sequence[HostOp]):
        self.fwd = _forward_spans(host)
        by_thread: Dict[int, List[Tuple[float, float, str]]] = {}
        backward = []
        for o in host:
            if o.name.startswith((SPAN_PREFIX, BACKWARD_NODE)):
                label = _own_label(o, self.fwd)[0]
                if label is not None:
                    by_thread.setdefault(o.thread, []).append((o.start_us, o.end_us, label))
            if o.name == SPAN_PREFIX + "backward":
                backward.append((o.start_us, o.end_us, "backward"))
        self.threads = {t: _Timeline(v) for t, v in by_thread.items()}
        self.backward = _Timeline(backward)

    def of(self, op: Optional[HostOp]) -> Tuple[str, str]:
        """(span, how): how is "span", "forward link", "backward open" or
        "outside"."""
        label, linked = _own_label(op, self.fwd)
        if label is not None:
            return label, "forward link" if linked else "span"
        if op is not None and self.backward.at(op.start_us) is not None:
            return "backward", "backward open"
        return OUTSIDE, "outside"

    def _lines(self, thread: Optional[int]) -> List[_Timeline]:
        """``thread``'s timeline, or every thread's for a record of no
        known thread."""
        return ([self.threads[thread]] if thread in self.threads
                else list(self.threads.values()))

    def at(self, thread: Optional[int], t: float) -> str:
        """The innermost span open at ``t`` on ``thread`` (see
        ``_lines``), else ``backward`` while the backward call is open,
        else outside."""
        hits = [h for h in (line.at(t) for line in self._lines(thread)) if h is not None]
        if hits:
            return min(hits, key=lambda h: h[1])[0]
        return "backward" if self.backward.at(t) is not None else OUTSIDE

    def split(self, thread: Optional[int], a: float, b: float) -> Dict[str, float]:
        """[a, b] split by what ``thread`` was inside, by time overlap."""
        lines = self._lines(thread) + [self.backward]
        cuts = sorted({a, b, *(p for line in lines for p in line.inside(a, b))})
        out: Dict[str, float] = {}
        for lo, hi in zip(cuts, cuts[1:]):
            label = self.at(thread, (lo + hi) / 2)
            out[label] = out.get(label, 0.0) + hi - lo
        return out


def _gaps(device: Sequence[DeviceOp]) -> Tuple[float, float, List[Tuple[float, float, DeviceOp]]]:
    """(busy, window, gaps) of the device events: the length of their union,
    from the first start to the last end, and each idle gap with the event
    that ended it."""
    evs = sorted(device, key=lambda d: (d.start_us, d.end_us))
    if not evs:
        return 0.0, 0.0, []
    busy, gaps = 0.0, []
    lo, hi = evs[0].start_us, evs[0].end_us
    for d in evs[1:]:
        if d.start_us > hi:
            busy += hi - lo
            gaps.append((hi, d.start_us, d))
            lo, hi = d.start_us, d.end_us
        else:
            hi = max(hi, d.end_us)
    busy += hi - lo
    return busy, hi - evs[0].start_us, gaps


def _add(d: Dict, k, v) -> None:
    d[k] = d.get(k, 0) + v


def host_self_times(host: Sequence[HostOp]) -> List[Tuple[HostOp, float]]:
    """Each host op with its self time (the ops inside it subtracted),
    spans and runtime calls left out: a CPU trace's work."""
    inner: Dict[int, float] = {}
    for o in host:
        if o.parent is not None:
            _add(inner, id(o.parent), o.end_us - o.start_us)
    return [(o, o.end_us - o.start_us - inner.get(id(o), 0.0)) for o in host
            if not o.name.startswith((SPAN_PREFIX, *RUNTIME))]


def attribute(host: Sequence[HostOp], device: Sequence[DeviceOp]) -> Dict:
    """Every device event, idle gap and host-card synchronisation of a
    profile handed to one span (names without ``litemkd/``; ``OUTSIDE``
    for none):

    - a device event: the span of the record that launched it, from the
      launch outwards: a backward node's span is that of the forward op
      with its (thread, sequence number), so a span counts its forward and
      its backward; else the innermost span around the launch; else
      ``backward`` if ``litemkd/backward`` was open when it was launched
      (a backward node whose forward op ran under no span, such as
      gradient accumulation); else ``OUTSIDE``;
    - an idle gap of the card (between the union's busy intervals): split
      by time overlap across what the thread that launched the event
      ending the gap was inside during the gap (its innermost span, or a
      backward node's forward span), ``backward`` while that call was
      open, else ``OUTSIDE``: idle between steps goes to the caller;
    - a synchronisation (a blocking runtime call of ``SYNC_CALLS``, an
      ``aten::_local_scalar_dense``, a copy to or from pageable memory):
      each op that makes one counts once, to its span as a launch's.

    Without device events (a trace of the CPU), each host op's self time
    takes the place of the device time. Returns ``time_us``, ``idle_us``
    and ``syncs`` by span, ``sync_ops`` ("<span>: <op>" → count),
    ``busy_us``, ``window_us`` (first device start
    to last end), ``idle_us_total``, ``what`` ("device" or "host self
    time"), and the backward's device time linked to a forward span
    (``backward_linked_us``) or left to ``backward`` (``backward_left_us``).
    """
    spans = _Spans(host)
    time_us: Dict[str, float] = {}
    idle_us: Dict[str, float] = {}
    syncs: Dict[str, int] = {}
    linked = left = 0.0
    if device:
        work = [(d.launch, d.end_us - d.start_us) for d in device]
        what = "device"
    else:
        work = host_self_times(host)
        what = "host self time"
    for launch, us in work:
        label, how = spans.of(launch)
        _add(time_us, label, us)
        if how == "forward link":
            linked += us
        elif label == "backward":
            left += us
    busy, window, gaps = _gaps(device)
    for a, b, d in gaps:
        for label, us in spans.split(d.launch.thread if d.launch else None, a, b).items():
            _add(idle_us, label, us)
    sites: Dict[int, HostOp] = {}
    for o in host:
        if o.name in SYNC_CALLS and o.parent is not None:
            sites[id(o.parent)] = o.parent
        elif o.name in SYNC_CALLS or o.name == SYNC_OP:
            sites[id(o)] = o
    for d in device:
        if "Pageable" in d.name and d.launch is not None:
            site = d.launch.parent or d.launch
            sites[id(site)] = site
    sync_ops: Dict[str, int] = {}
    for site in sites.values():
        label, how = spans.of(site)
        if how == "outside":
            label = spans.at(site.thread, site.start_us)
        _add(syncs, label, 1)
        _add(sync_ops, f"{label}: {site.name}", 1)
    return {"time_us": time_us, "idle_us": idle_us, "syncs": syncs,
            "sync_ops": sync_ops, "what": what,
            "busy_us": busy, "window_us": window, "idle_us_total": window - busy,
            "backward_linked_us": linked, "backward_left_us": left}


def profile_records(prof) -> Tuple[List[HostOp], List[DeviceOp]]:
    """The host records (ops, spans, runtime calls, each with the op around
    it) and the device events of a ``torch.profiler`` profile. A device
    event is tied to the runtime call of its correlation id, else to the
    op the profiler linked it to; a device-typed user annotation is no
    device event."""
    cuda = torch.autograd.DeviceType.CUDA
    evts = list(prof.events())
    made: Dict[int, HostOp] = {}

    def rec(e) -> Optional[HostOp]:
        if e is None:
            return None
        r = made.get(id(e))
        if r is None:
            r = made[id(e)] = HostOp(e.name, e.thread, e.time_range.start,
                                     e.time_range.end, None, e.sequence_nr, e.fwd_thread)
            r.parent = rec(e.cpu_parent)
        return r

    host_evts = [e for e in evts if e.device_type != cuda]
    host = [rec(e) for e in host_evts]
    runtime = {e.id: e for e in host_evts if e.name.startswith(RUNTIME)}
    ops = {e.id: e for e in host_evts if not e.name.startswith(RUNTIME)}
    device = []
    for e in evts:
        if e.device_type == cuda and not e.is_user_annotation:
            call = runtime.get(e.id)
            if call is None:
                call = ops.get(e.linked_correlation_id or -1)
            device.append(DeviceOp(e.name, e.time_range.start, e.time_range.end,
                                   rec(call)))
    return host, device


def shares(rep: Dict) -> Dict[str, Optional[float]]:
    """Shares of :func:`attribute`'s result, in %: the time outside the
    program and in ``step`` alone, the backward's time linked to a forward
    span, and the idle time inside program spans (None where there is
    nothing to share)."""
    total = sum(rep["time_us"].values())
    bwd = rep["backward_linked_us"] + rep["backward_left_us"]
    inside = sum(v for k, v in rep["idle_us"].items() if k != OUTSIDE)
    return {"outside_pct": 100 * rep["time_us"].get(OUTSIDE, 0.0) / total if total else None,
            "step_alone_pct": 100 * rep["time_us"].get("step", 0.0) / total if total else None,
            "backward_linked_pct": 100 * rep["backward_linked_us"] / bwd if bwd else None,
            "idle_in_program_pct": (100 * inside / rep["idle_us_total"]
                                    if rep["idle_us_total"] > 0 else None)}


def report_lines(rep: Dict, units: int, unit: str = "step") -> List[str]:
    """:func:`attribute`'s result per ``unit`` as printable lines: each
    span's time, idle and syncs, largest first, then its :func:`shares`."""
    n = max(units, 1)
    lines = [f"by program span, per {unit} ({rep['what']} ms / idle ms / syncs):"]
    for k in sorted(set(rep["time_us"]) | set(rep["idle_us"]) | set(rep["syncs"]),
                    key=lambda k: -rep["time_us"].get(k, 0.0)):
        lines.append(f"{rep['time_us'].get(k, 0.0) / 1e3 / n:10.3f} "
                     f"{rep['idle_us'].get(k, 0.0) / 1e3 / n:9.3f} "
                     f"{rep['syncs'].get(k, 0) / n:7.2f}  {k}")
    if rep["window_us"] > 0:
        lines.append(f"device busy {rep['busy_us'] / 1e3 / n:.3f} ms in "
                     f"{rep['window_us'] / 1e3 / n:.3f} a {unit}, idle "
                     f"{rep['idle_us_total'] / 1e3 / n:.3f}")
    if rep["sync_ops"]:
        lines.append("syncs by op: " + ", ".join(
            f"{k} {v / n:.2f}" for k, v in sorted(rep["sync_ops"].items())))
    lines.append("shares (%): " + ", ".join(
        f"{k[:-4]} {'-' if v is None else f'{v:.2f}'}" for k, v in shares(rep).items()))
    return lines

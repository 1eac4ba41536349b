"""The program's spans in a profile: every device event, idle gap and
host-card synchronisation of a profile with host activity handed to one
``litemkd/<name>`` span of the program. This is the benchmark's own copy
of that arithmetic (``litemkd_torch.cli.profile`` has another for the
operator), so a change to the program cannot move the yardstick that
reads its spans.

:func:`records` flattens a profile as :func:`portbench.trace.events` does
(a device event tied to the runtime call of its correlation id, else to
the op the profiler linked it to) and keeps what the attribution needs
besides: each host record's thread, interval, parent, autograd sequence
number and forward thread. A device-typed user annotation is no device
event. :func:`attribute` works on those records alone, so it is testable
without a card.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from portbench.trace import RUNTIME, busy_union

PREFIX = "litemkd/"
OUTSIDE = "(outside the program)"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
SYNC_OP = "aten::_local_scalar_dense"


@dataclass(eq=False)
class Op:
    """A host op, span or runtime call of one thread, with the op around it.
    ``seq`` is its autograd sequence number (-1 for none); a backward node
    has the ``seq`` and, as ``fwd_thread``, the ``thread`` of the forward
    op that made it (0 for a forward op)."""
    name: str
    thread: int
    start_us: float
    end_us: float
    parent: Optional["Op"] = None
    seq: int = -1
    fwd_thread: int = 0


@dataclass(eq=False)
class Kernel:
    """A kernel, copy or set of the card and the host record that launched
    it."""
    name: str
    start_us: float
    end_us: float
    launch: Optional[Op] = None


def chain(op: Optional[Op]) -> Iterator[Op]:
    while op is not None:
        yield op
        op = op.parent


def innermost_span(names: Sequence[str]) -> Optional[str]:
    """The first ``litemkd/`` name of a chain of op names (innermost first),
    as :func:`portbench.trace.events` gives it."""
    return next((n for n in names if n.startswith(PREFIX)), None)


def records(prof) -> Tuple[List[Op], List[Kernel]]:
    """The host records and device events of a ``torch.profiler`` profile."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    evts = list(prof.events())
    made: Dict[int, Op] = {}

    def rec(e) -> Optional[Op]:
        if e is None:
            return None
        r = made.get(id(e))
        if r is None:
            r = made[id(e)] = Op(e.name, e.thread, e.time_range.start, e.time_range.end,
                                 None, e.sequence_nr, e.fwd_thread)
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
                call = ops.get(getattr(e, "linked_correlation_id", 0) or -1)
            device.append(Kernel(e.name, e.time_range.start, e.time_range.end, rec(call)))
    return host, device


def _label(op: Optional[Op], fwd: Dict[Tuple[int, int], str]) -> Tuple[Optional[str], bool]:
    """(span, through a backward node) of the work launched from ``op``: the
    first, from ``op`` outwards, of a backward node whose forward op ran
    under a span (that span) and a span."""
    for o in chain(op):
        if o.name.startswith(BACKWARD_NODE):
            s = fwd.get((o.fwd_thread, o.seq))
            if s is not None:
                return s, True
        if o.name.startswith(PREFIX):
            return o.name[len(PREFIX):], False
    return None, False


class _Line:
    """Nested labelled intervals of one thread: ``at(t)`` is the innermost
    one open at ``t`` as (label, length)."""

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
    def __init__(self, host: Sequence[Op]):
        self.fwd: Dict[Tuple[int, int], str] = {}
        for o in host:
            if o.seq >= 0 and o.fwd_thread == 0 and not o.name.startswith(BACKWARD_NODE):
                s = innermost_span([c.name for c in chain(o)])
                if s is not None:
                    self.fwd.setdefault((o.thread, o.seq), s[len(PREFIX):])
        by_thread: Dict[int, List[Tuple[float, float, str]]] = {}
        backward = []
        for o in host:
            if o.name.startswith((PREFIX, BACKWARD_NODE)):
                label = _label(o, self.fwd)[0]
                if label is not None:
                    by_thread.setdefault(o.thread, []).append((o.start_us, o.end_us, label))
            if o.name == PREFIX + "backward":
                backward.append((o.start_us, o.end_us, "backward"))
        self.threads = {t: _Line(v) for t, v in by_thread.items()}
        self.backward = _Line(backward)

    def of(self, op: Optional[Op]) -> Tuple[str, str]:
        """(span, how): "span", "forward link", "backward open" or "outside"."""
        label, linked = _label(op, self.fwd)
        if label is not None:
            return label, "forward link" if linked else "span"
        if op is not None and self.backward.at(op.start_us) is not None:
            return "backward", "backward open"
        return OUTSIDE, "outside"

    def _lines(self, thread: Optional[int]) -> List[_Line]:
        return ([self.threads[thread]] if thread in self.threads
                else list(self.threads.values()))

    def at(self, thread: Optional[int], t: float) -> str:
        hits = [h for h in (line.at(t) for line in self._lines(thread)) if h is not None]
        if hits:
            return min(hits, key=lambda h: h[1])[0]
        return "backward" if self.backward.at(t) is not None else OUTSIDE

    def split(self, thread: Optional[int], a: float, b: float) -> Dict[str, float]:
        lines = self._lines(thread) + [self.backward]
        cuts = sorted({a, b, *(p for line in lines for p in line.inside(a, b))})
        out: Dict[str, float] = {}
        for lo, hi in zip(cuts, cuts[1:]):
            _add(out, self.at(thread, (lo + hi) / 2), hi - lo)
        return out


def _add(d: Dict, k, v) -> None:
    d[k] = d.get(k, 0) + v


def attribute(host: Sequence[Op], device: Sequence[Kernel]) -> Dict:
    """Every device event, idle gap and host-card synchronisation handed to
    one span (names without ``litemkd/``; ``OUTSIDE`` for none):

    - a device event: from its launch outwards, a backward node's span is
      that of the forward op with its (thread, sequence number), so a span
      counts its forward and its backward; else the innermost span around
      the launch; else ``backward`` if ``litemkd/backward`` was open when
      it was launched; else ``OUTSIDE``;
    - an idle gap of the card: split by time overlap across what the thread
      that launched the event ending the gap was inside during the gap
      (its innermost span, a backward node's forward span, ``backward``
      while that call was open, else ``OUTSIDE``);
    - a synchronisation (a blocking runtime call of ``SYNC_CALLS``, an
      ``aten::_local_scalar_dense``, a copy to or from pageable memory):
      each op that makes one counts once, to its span.

    Without device events (a trace of the CPU), each host op's self time
    takes the place of the device time. Returns ``time_us``, ``idle_us``
    and ``syncs`` by span, ``sync_ops`` ("<span>: <op>" → count),
    ``what``, ``busy_us``, ``window_us``, ``idle_us_total``, and the
    backward's device time linked to a forward span
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
        inner: Dict[int, float] = {}
        for o in host:
            if o.parent is not None:
                _add(inner, id(o.parent), o.end_us - o.start_us)
        work = [(o, o.end_us - o.start_us - inner.get(id(o), 0.0)) for o in host
                if not o.name.startswith((PREFIX, *RUNTIME))]
        what = "host self time"
    for launch, us in work:
        label, how = spans.of(launch)
        _add(time_us, label, us)
        if how == "forward link":
            linked += us
        elif label == "backward":
            left += us
    evs = sorted(device, key=lambda d: (d.start_us, d.end_us))
    busy, window, gaps = busy_union([(d.start_us, d.end_us) for d in evs])
    first_at = {}
    for d in evs:
        first_at.setdefault(d.start_us, d)
    for a, b in gaps:
        launch = first_at[b].launch
        for label, us in spans.split(launch.thread if launch else None, a, b).items():
            _add(idle_us, label, us)
    sites: Dict[int, Op] = {}
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


def shares(rep: Dict) -> Dict[str, Optional[float]]:
    """In %: the device time outside the program and in ``step`` alone, the
    backward's time linked to a forward span, and the idle time inside
    program spans (None where there is nothing to share)."""
    total = sum(rep["time_us"].values())
    bwd = rep["backward_linked_us"] + rep["backward_left_us"]
    inside = sum(v for k, v in rep["idle_us"].items() if k != OUTSIDE)
    return {"outside_pct": 100 * rep["time_us"].get(OUTSIDE, 0.0) / total if total else None,
            "step_alone_pct": 100 * rep["time_us"].get("step", 0.0) / total if total else None,
            "backward_linked_pct": 100 * rep["backward_linked_us"] / bwd if bwd else None,
            "idle_in_program_pct": (100 * inside / rep["idle_us_total"]
                                    if rep["idle_us_total"] > 0 else None)}


def report_lines(rep: Dict, units: int, unit: str = "step") -> List[str]:
    """:func:`attribute`'s result per ``unit``: each span's time, idle and
    syncs, largest first, then its :func:`shares`."""
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

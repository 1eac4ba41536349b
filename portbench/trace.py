"""The device trace of a run's profiled tail, reduced to what the per-layer
readers read.

:func:`tail` profiles a run's tail three times with :func:`profiled`:
with device activity alone, which leaves the host's pace as it is and
gives the busy union, the span and the device ops that took most time;
with host activity too, which ties every device event to the host ops
above its launch (the kernel time under named ops, and the idle gaps by
what the host was doing); and one unit with the ops' input shapes, for the
TCT calls. :func:`events` flattens a profile into plain records: every
device event (kernel, copy, set) with its interval and the names of the
host ops above the op that launched it, and every call of the TCT op with
its operand shapes and its kernels' device time. :func:`summarize` then
works on those records alone, so the arithmetic is testable without a
card: the busy union of the device intervals over the span from the first
device start to the last device end, the idle gaps between them, named by
the host op that launched the kernel that ended each gap, and the device
ops that took the most time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

TCT_OP = "litemkd::tct_attention"
RUNTIME = ("cuda", "cu")       # CUDA runtime and driver API calls


@dataclass
class DeviceEvent:
    name: str
    start_us: float
    end_us: float
    ops: Tuple[str, ...]      # host ops from the launching one outwards


@dataclass
class OpCall:
    name: str
    shapes: List[List[int]]
    kernel_us: float


def profiled(fn: Callable[[], None], device, shapes: bool = False,
             host: bool = True) -> object:
    """``fn()`` under the profiler, the device synchronised before it
    stops; returns the profiler. ``shapes`` records the ops' input shapes,
    which slows the host further. ``host`` False records device activity
    alone (on a card; the CPU has no other)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + \
        ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=shapes) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    return prof


def events(prof) -> Tuple[List[DeviceEvent], List[OpCall]]:
    """Device events and TCT op calls of a profiler's trace. A device event
    is tied to the runtime call that launched it (same correlation id) and
    so to the host op around that call; a TCT call's time is that of the
    device events under it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    evts = list(prof.events())
    host = [e for e in evts if e.device_type != cuda]
    runtime = {e.id: e for e in host if e.name.startswith(RUNTIME)}
    ops = {e.id: e for e in host if not e.name.startswith(RUNTIME)}
    out, spent = [], {}
    for e in evts:
        if e.device_type == cuda:
            call = runtime.get(e.id)
            op = (call.cpu_parent if call is not None
                  else ops.get(getattr(e, "linked_correlation_id", 0) or -1))
            chain = []
            while op is not None:
                chain.append(op.name)
                if op.name == TCT_OP:
                    spent[id(op)] = spent.get(id(op), 0.0) + e.time_range.end - e.time_range.start
                op = op.cpu_parent
            out.append(DeviceEvent(e.name, e.time_range.start, e.time_range.end,
                                   tuple(chain)))
    calls = [OpCall(e.name, [list(s) for s in e.input_shapes[:4]], spent.get(id(e), 0.0))
             for e in host if e.name == TCT_OP]
    return out, calls


def tail(fn: Callable[[], None], one: Callable[[], None], units: int, device) -> Dict:
    """The summary of ``fn()``, a tail of ``units`` steps or requests,
    profiled with device activity alone and again with host activity, and
    of ``one()`` with shapes (see the module's text)."""
    quiet = events(profiled(fn, device, host=False))[0]
    dev = events(profiled(fn, device))[0]
    calls = events(profiled(one, device, shapes=True))[1]
    return summarize(dev, calls, units, quiet)


def busy_union(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, float, List[Tuple[float, float]]]:
    """(busy, span, gaps) of intervals: the length of their union, the
    length from the first start to the last end, and the idle gaps between."""
    spans = sorted(intervals)
    if not spans:
        return 0.0, 0.0, []
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((hi, a))
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, hi - spans[0][0], gaps


def idle_by_host_op(dev: Sequence[DeviceEvent], gaps: Sequence[Tuple[float, float]]
                    ) -> Dict[str, float]:
    """Idle µs summed by the host op that launched the device event that
    ended each gap (what the host was doing while the device waited)."""
    starts = sorted(dev, key=lambda e: e.start_us)
    by: Dict[str, float] = {}
    j = 0
    for a, b in sorted(gaps):
        while j < len(starts) and starts[j].start_us < b:
            j += 1
        nxt = starts[j] if j < len(starts) else None
        name = nxt.ops[0] if nxt is not None and nxt.ops else "(no host op)"
        by[name] = by.get(name, 0.0) + (b - a)
    return by


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    """The n largest entries as [name, seconds] (µs in, seconds out)."""
    return [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def summarize(dev: Sequence[DeviceEvent], calls: Sequence[OpCall], units: int,
              quiet: Optional[Sequence[DeviceEvent]] = None) -> Dict:
    """What the readers take: ``units`` (steps or requests in the tail),
    ``busy_s`` and ``span_s``, each kernel as [name, seconds, host ops],
    the TCT calls, and the breakdown's two top-10 lists. ``quiet``: the
    device events of the same tail profiled without host activity, which
    give the busy union, the span, each kernel name's seconds
    (``named_s``) and the top device ops where it has any;
    ``hosted_busy_s`` and ``hosted_span_s`` are those of ``dev``."""
    busy, span, gaps = busy_union([(e.start_us, e.end_us) for e in dev])
    hosted = (busy, span)
    if quiet:
        busy, span, _ = busy_union([(e.start_us, e.end_us) for e in quiet])
    by_name: Dict[str, float] = {}
    for e in (quiet or dev):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.end_us - e.start_us
    return {"units": units, "busy_s": busy / 1e6, "span_s": span / 1e6,
            "hosted_busy_s": hosted[0] / 1e6, "hosted_span_s": hosted[1] / 1e6,
            "quiet": bool(quiet),
            "unlinked": sum(1 for e in dev if not e.ops),
            "kernels": [[e.name, (e.end_us - e.start_us) / 1e6, list(e.ops)] for e in dev],
            "named_s": {k: v / 1e6 for k, v in by_name.items()},
            "tct": [{"shapes": c.shapes, "kernel_s": c.kernel_us / 1e6} for c in calls],
            "device_ops": top(by_name), "idle_gaps": top(idle_by_host_op(dev, gaps))}


def seconds_under(summary: Dict, ops: Sequence[str]) -> float:
    """Device seconds of the kernels launched under any of ``ops``."""
    want = set(ops)
    return sum(s for _, s, chain in summary["kernels"] if want.intersection(chain))


def seconds_named(summary: Dict, needle: str) -> float:
    """Device seconds of the kernels whose name holds ``needle``, from the
    device-only profile where there is one: under host activity a rank
    that the profiler slows holds the others' collectives waiting."""
    return sum(s for name, s in summary["named_s"].items() if needle in name.lower())

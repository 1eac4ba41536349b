"""One run of one cell: set-up, the timed window, the optional traced tail,
the correctness check, and the result line.

``main`` refuses to run without as many CUDA cards as the cell asks for;
:func:`run_cell` is the rest of a run, which the CPU tests drive at tiny
sizes with ``device="cpu"``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit; the same numbers are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "litemkd_tpu")


@dataclass
class Args:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0               # perf_counter at process start


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole (``litemkd_torch`` is not ``litemkd_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_note() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi: not found"
    out = subprocess.run([smi, "--query-gpu=index,name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return "cards: " + "; ".join(out.stdout.strip().splitlines())


def percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default), inf-aware."""
    v = sorted(values)
    if not v:
        return math.inf
    pos = (len(v) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(v[hi]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def _eps_per_s(o):
    return o["episodes"] / o["window_s"] if "episodes" in o else None


END_TO_END = {
    "train_eps_per_s": _eps_per_s,
    "train_eps_per_s.dp4": _eps_per_s,
    "teacher_train_eps_per_s": _eps_per_s,
    "request_ms_p95": lambda o: percentile(o["latencies_ms"], 95) if "latencies_ms" in o else None,
    "peak_mem_gib": lambda o: o["peak_bytes"] / 2 ** 30,
    "setup_s": lambda o: o["setup_s"],
}


def metrics(cell, outcome: Dict, traced: bool, notes: List[str]) -> Dict[str, Dict]:
    out = {}
    if not traced:
        for m in cell.end_to_end:
            v = END_TO_END[m["name"]](outcome)
            if v is None:
                raise RuntimeError(f"{cell.name}: no reading of {m['name']}")
            out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    from . import spec
    ctx = {"cell": cell, "outcome": outcome, "trace": outcome.get("trace"), "notes": notes}
    for m in cell.per_layer:
        v = spec.layer_reader(cell.root, m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(root: Path, args: Args) -> Dict:
    """Everything of a run but the look for a card and the printing:
    returns the result object."""
    from . import spec
    cell = spec.load_cell(root, args.workload)
    kind = cell.mix["driver"]
    outcome = spec.driver(root, kind).run(cell, args)
    readings = outcome["checks"]
    checks = {k: v for k, v in readings.items() if k in cell.limits}
    missing = spec.check_limits(cell, {k: v for k, (v, _) in checks.items()})
    if missing:
        raise RuntimeError(f"{cell.name}: {missing}")
    notes = list(outcome.get("notes", []))
    notes += [f"reading {k} (not compared): {v!r} {where}"
              for k, (v, where) in readings.items() if k not in cell.limits]
    correct = (outcome["failed"] == 0 and outcome["attempted"] > 0 and
               all(math.isfinite(v) and v <= cell.limits[k] for k, (v, _) in checks.items()))
    result = {"correct": bool(correct), "attempted": outcome["attempted"],
              "failed": outcome["failed"],
              "metrics": metrics(cell, outcome, args.trace, notes),
              "device": dict(outcome["device"])}
    if args.trace and outcome.get("trace"):
        t = outcome["trace"]
        notes.append(f"trace: {t['units']} units in {t['span_s']:.6f} s, device busy "
                     f"{t['busy_s']:.6f} s (device activity alone: {t['quiet']}); with "
                     f"host activity {t['hosted_span_s']:.6f} s, busy "
                     f"{t['hosted_busy_s']:.6f} s; {t['unlinked']} of {len(t['kernels'])} "
                     f"device events tied to no host op; {len(t['tct'])} TCT calls with "
                     f"shapes")
        if outcome.get("units"):
            notes.append(f"per unit: traced tail {1e3 * t['span_s'] / t['units']:.4f} ms "
                         f"(with host activity {1e3 * t['hosted_span_s'] / t['units']:.4f}),"
                         f" window {1e3 * outcome['window_s'] / outcome['units']:.4f} ms")
        result["device"].update(busy_s=t["busy_s"], window_s=t["span_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]}
                        for k, (v, _) in checks.items()}
    result["_where"] = {k: where for k, (_, where) in checks.items()}
    result["_notes"] = notes
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, root: Path, t0: float) -> int:
    ns = parse(argv)
    from . import spec
    cell = spec.load_cell(root, ns.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run_cell(root, Args(ns.workload, ns.seed, ns.seconds, bool(ns.trace),
                                 "cuda", t0))
    found = forbidden_modules() + result["device"].pop("forbidden", [])
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 4
    for line in result.pop("_notes"):
        print(line, file=sys.stderr)
    print(card_note(), file=sys.stderr)
    where = result.pop("_where")
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {where[k]}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0

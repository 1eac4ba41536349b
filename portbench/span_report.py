"""The program's spans in a cell's traced tail: every kernel, idle gap and
host-card synchronisation of the tail handed to one ``litemkd/`` span by
the benchmark's attribution (:func:`portbench.spans.attribute`), per step
or request:

    python3 -m portbench.span_report --workload student.train --seed 7 [--units 3]

It sets the cell up as its driver does, on one card: a training cell's
state, step and pool through :mod:`portbench.checked` (the checked steps
warm every shape), the serving cell's scorer and request pool through the
serving driver's ``build`` and its warm-up requests. Then ``--units`` steps
or requests run back to back under the profiler with host activity, as
the second profile of a ``--trace 1`` tail does (:func:`portbench.trace.
profiled`). It prints the attribution per unit and, last, one JSON line:
``units``, the attribution's numbers (µs over the tail) and the shares the
notes of a traced run would give. The data-parallel cell is not run here.

This is a tail of its own beside ``run.py --trace 1``, not the timed
cell's: it stays until :func:`portbench.trace.tail` carries the spans in
its summary, and goes then.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def tail(cell, seed: int, units: int, device):
    """``(fn, unit)``: ``fn()`` runs ``units`` steps or requests of the cell
    back to back; ``unit`` names them."""
    from portbench import checked, spec
    if cell.mix["driver"] == "serve_open_loop":
        serve_driver = spec.driver(cell.root, "serve_open_loop")
        args = argparse.Namespace(seed=seed)
        pool, serve = serve_driver.build(cell, args, device)[3:5]
        for j in range(cell.mix.get("warmup", 3)):
            serve(pool[j % len(pool)])
        return lambda: [serve(pool[i % len(pool)]) for i in range(units)], "request"
    b = checked.build(cell, seed, device)
    pool = checked.checked_steps(cell, b, seed, device)["pool"]
    return lambda: [b.step(b.state, pool[i % len(pool)]) for i in range(units)], "step"


def report(root: Path, workload: str, seed: int, units: int, device) -> dict:
    """The attribution of ``units`` steps or requests of ``workload`` (a
    cell of ``root/BENCHMARK.json``) with its shares, ``units`` and
    ``unit``."""
    from portbench import spans, spec, trace
    cell = spec.load_cell(root, workload)
    fn, unit = tail(cell, seed, units, device)
    rep = spans.attribute(*spans.records(trace.profiled(fn, device)))
    return {"workload": cell.name, "units": units, "unit": unit, **spans.shares(rep), **rep}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="The program's spans in a cell's traced tail.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=3)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    import torch

    from portbench.spans import report_lines
    rep = report(ROOT, ns.workload, ns.seed, ns.units, torch.device(ns.device))
    print("\n".join(report_lines(rep, ns.units, rep["unit"])), file=sys.stderr)
    print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())

"""Readings that the limits of a cell's check are set from, and the serving
sweep, in one process on one card:

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--controls 3] [--fp32-witness] [--bf16-reference] [--sweep 40 60 80] \\
        [--seconds 10] --out <file.json>

For a training cell, on each seed the program's checked steps
(:func:`portbench.checked.checked_steps`, as a run takes them; the train
state built once, the weights and dropout generators laid anew for each
seed) against the reference's, as a run compares them: the lower
readings. On the first ``--controls`` seeds also the readings of the
control (the reference one precision step below the configuration:
:data:`portbench.reference.common.CONTROL`) and of the faults planted in
the reference put in the program's place: half of each chunk's episodes
left out and the rest's loss doubled, and in a data-parallel cell each
replica stepping on its own chunk (the exchange left out); with
``--fp32-witness`` the program with its trunk in fp32 (a second witness of
how far its bf16 trunk alone moves it), with ``--bf16-reference`` the
reference with bf16 trunk operands. A state left unchanged reads 1 on
``update_gap`` and ``change_gap`` by construction and needs no run; an
update at 1.5 times its scale reads 0.5 on ``update_gap``.

For a serving cell, on each seed the program's scored requests against the
reference's, the control's and an answer altered where it is produced
(one query's logits swapped with another's); with ``--sweep`` the open
loop at each rate for ``--seconds``, with its backlog at the close.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _training(cell, seeds, controls, device, fp32_witness=False, bf16_reference=False):
    import dataclasses

    import torch
    from portbench import check, checked, program
    from portbench.reference.common import CONTROL, Precision
    replicas = cell.mix.get("ranks", 1)
    built = checked.build(cell, seeds[0], device) if replicas == 1 else None
    witness = None
    if fp32_witness:
        cfg = program.config(cell.config, seeds[0])
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
        witness = checked.build(cell, seeds[0], device, cfg=cfg)
    some = built or witness or checked.build(cell, seeds[0], device)
    fam, shapes = some.fam, some.shapes
    out = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        rec = {"seed": seed}
        runs = {}
        if built is not None:
            runs["program"] = checked.checked_steps(cell, built, seed, device, fresh=False)
        if witness is not None and i < controls:
            runs["program_fp32"] = checked.checked_steps(cell, witness, seed, device,
                                                         fresh=False)
        for r in runs.values():
            r.pop("pool")
        w, batches = checked.reference_inputs(cell, fam, shapes, seed, device)
        truth = fam.reference_steps(cell.config, w, batches, seed, replicas=replicas)
        start = w["model"]
        for name, r in runs.items():
            rec[name] = check.training(r, truth, start, fam.HEAD)
        if i < controls:
            planted = {"control": dict(prec=CONTROL), "half_batch": dict(half_batch=True)}
            if replicas > 1:
                planted["no_exchange"] = dict(exchange=False)
            if bf16_reference:
                planted["bf16_reference"] = dict(prec=Precision(trunk="bf16"))
            for name, kw in planted.items():
                rec[name] = check.training(fam.reference_steps(
                    cell.config, w, batches, seed, replicas=replicas, **kw), truth, start,
                    fam.HEAD)
        rec["seconds"] = time.perf_counter() - t
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del w, batches, truth, runs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _serving(cell, seeds, controls, sweep, seconds, device):
    import numpy as np
    import torch
    from portbench import check, harness
    from portbench.drivers import serve_open_loop as srv
    from portbench.families import draw
    from portbench.reference.common import CONTROL
    out = []
    for i, seed in enumerate(seeds):
        args = harness.Args(cell.name, seed, seconds, False, "cuda")
        fam, shapes, served, pool, serve, _ = srv.build(cell, args, device)
        w = draw(shapes, seed, device)["model"]
        rec = {"seed": seed, "program": 0.0}
        if i < controls:
            rec.update(control=0.0, altered=0.0)
        for req in pool[: cell.mix["check_requests"]]:
            got = serve(req)
            d = {k: v.to(device) for k, v in req.items()}
            ref = fam.reference_score(cell.config, w, served, d)
            rec["program"] = max(rec["program"], check.logit_gap(got, ref))
            if i < controls:
                ctl = fam.reference_score(cell.config, w, served, d, CONTROL)
                rec["control"] = max(rec["control"], check.logit_gap(ctl, ref))
                bad = got.clone()
                bad[0, [0, 1]] = got[0, [1, 0]]
                rec["altered"] = max(rec["altered"], check.logit_gap(bad, ref))
        print(json.dumps(rec), flush=True)
        out.append(rec)
        if i == 0 and sweep:
            for rate in sweep:
                arr = srv.arrivals(rate, seconds, cell.mix["gaps_seed"])
                picks = np.random.default_rng(seed).integers(len(pool), size=len(arr))
                recs, _ = srv.serve_window(serve, pool, arr, picks, seconds)
                st = srv.stats(recs, seconds)
                row = {"rate": rate, "offered": len(arr), "backlog": st["backlog"],
                       "completed_by_s": st["span_s"],
                       "p50_ms": harness.percentile(st["latencies_ms"], 50),
                       "p95_ms": harness.percentile(st["latencies_ms"], 95),
                       "service_ms": st["service_s"] / len(arr) * 1e3,
                       "late_max_ms": st["late_max_s"] * 1e3}
                print(json.dumps({"sweep": row}), flush=True)
                out.append({"sweep": row})
        del serve, pool, w
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--sweep", type=float, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fp32-witness", action="store_true",
                   help="also the program with an fp32 trunk, on the control seeds")
    p.add_argument("--bf16-reference", action="store_true",
                   help="also the reference with bf16 trunk operands, on the control seeds")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.load_cell(ROOT, a.workload)
    device = torch.device("cuda")
    if cell.mix["driver"] == "serve_open_loop":
        rows = _serving(cell, a.seeds, a.controls, a.sweep, a.seconds, device)
    else:
        rows = _training(cell, a.seeds, a.controls, device, a.fp32_witness,
                         a.bf16_reference)
    with open(a.out, "w") as f:
        json.dump({"workload": a.workload, "card": torch.cuda.get_device_name(0),
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

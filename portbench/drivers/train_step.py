"""Training traffic on one card: optimizer steps one after another, on a pool
of batches made on the card from the seed.

Set-up builds the program's train state, lays the benchmark's weights over
it and drives the first ``check_steps`` steps through the window's own
call and feed, on pool batches that all differ (:mod:`portbench.checked`).
Those steps also warm every shape. The window then runs steps through the pool
for ``--seconds``, one step queued ahead of the one the host waits for,
and ends when the last launched step has finished. With ``--trace 1`` a
tail of ``trace_steps`` steps runs under the profiler after the window.
Once the program's state is freed, the reference repeats the checked steps
from the same weights and batches.

Mix parameters: ``pool`` (batches), ``check_steps``, ``trace_steps``.
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import check, checked, harness, program, trace


def device_info(device, chips: int, peak: int) -> dict:
    d = torch.device(device)
    if d.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(d), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}


def peak_bytes(device) -> int:
    d = torch.device(device)
    return torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0


class Window:
    """Runs ``step(i)`` for i = 0, 1, ... until ``seconds`` have passed, the
    host waiting on step i − 1 while step i is queued; the window closes
    when the last step has finished."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device

    def run(self, step, seconds: float):
        t0 = time.perf_counter()
        n, prev = 0, None
        while True:
            step(n)
            n += 1
            if self.cuda:
                evt = torch.cuda.Event()
                evt.record()
                if prev is not None:
                    prev.synchronize()
                prev = evt
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(self.device)
        return n, t0, time.perf_counter()


def run(cell, args) -> dict:
    device = torch.device(args.device)
    mix = cell.mix
    marks = [time.perf_counter()]
    b = checked.build(cell, args.seed, device)
    marks.append(time.perf_counter())
    rec = checked.checked_steps(cell, b, args.seed, device)
    marks.append(time.perf_counter())
    pool, step, state, e = rec.pop("pool"), b.step, b.state, b.cfg.train.tasks_per_batch
    n_check = mix["check_steps"]
    harness.sync(device)
    launches0 = program.tct_launches()
    window_losses = []

    def one(i):
        window_losses.append(program.step_loss(step(state, pool[(n_check + i) % len(pool)])))

    n, t0, t1 = Window(device).run(one, args.seconds)
    launches = program.tct_launches() - launches0
    lw = torch.stack(window_losses).double().cpu()
    failed = int((~torch.isfinite(lw)).sum())
    summary = None
    if args.trace:
        k = mix["trace_steps"]
        summary = trace.tail(lambda: [step(state, pool[i % len(pool)]) for i in range(k)],
                             lambda: step(state, pool[0]), k, device)
    peak = peak_bytes(device)
    fam, shapes = b.fam, b.shapes
    del b, state, pool, step, window_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    w, batches = checked.reference_inputs(cell, fam, shapes, args.seed, device)
    ref = fam.reference_steps(cell.config, w, batches, args.seed)
    numbers = check.training(rec, ref, w["model"], fam.HEAD)
    t_ref = time.perf_counter() - t_ref
    notes = [f"window: {n} steps of {e} episodes in {t1 - t0:.6f} s; "
             f"{launches} TCT launches ({launches / max(n, 1):.2f} a step)",
             f"set-up: {marks[0] - args.t0:.3f} s to the driver, {marks[1] - marks[0]:.3f} s "
             f"state and step, {marks[2] - marks[1]:.3f} s weights, pool and checked steps",
             f"checked steps' losses: program {rec['losses']}, reference {ref['losses']}",
             f"reference check: {t_ref:.3f} s"]
    return {"setup_s": t0 - args.t0, "window_s": t1 - t0, "units": n,
            "episodes": n * e, "attempted": n, "failed": failed, "peak_bytes": peak,
            "device": device_info(device, 1, peak), "trace": summary,
            "checks": numbers, "notes": notes}

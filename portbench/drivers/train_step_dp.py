"""Data-parallel training traffic: ``ranks`` processes, one card each, joined
by NCCL (gloo on the CPU) over ``tcp://127.0.0.1``, each stepping its
``tasks_per_batch / ranks`` episodes of every batch through
``make_train_step(cfg, dp)``: the gradient all-reduce and the replicas'
metrics are the program's.

This process is rank 0; it starts the others (``spawn``) and waits for
them. Every rank makes its own slice of each pool batch from the seed, as
:mod:`portbench.drivers.train_step` makes the whole batch, draws the same
weights, and runs the same set-up, window and traced tail; the window's
end is decided together (a flag all-reduced and read one step behind,
from pinned memory), so every rank runs the same steps and the host keeps
one step queued ahead of the one it waits for. Afterwards each rank holds
its own parameters against the reference's one-process steps on the global
batch, run on its own card, and rank 0 gathers the numbers, peaks, traces and loaded module
names of all ranks.
"""
from __future__ import annotations

import datetime
import gc
import math
import multiprocessing as mp
import os
import socket
import sys
import time
import traceback

import torch
import torch.distributed as dist

from portbench import check, checked, harness, program, trace
from portbench.drivers.train_step import device_info, peak_bytes

JOIN_S = 300.0
GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class EndFlags:
    """The window's end, agreed by every rank without holding the host back.
    After each step every rank all-reduces (max) whether its clock has passed
    the window's length, copies the flag into pinned host memory behind the
    step and records an event; the host then waits only for the previous
    step's event and reads that step's flag, so one step stays queued ahead
    of the one the host waits for, as on one card. (A flag made with
    ``torch.tensor(..., device=...)`` or read with ``float()`` of a card's
    tensor waits for the card to drain at every step.)"""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device
        self.host = torch.zeros(2, pin_memory=self.cuda)
        self.prev = None              # (event, slot) of the previous step
        self.n = 0

    def agreed_late(self, late: bool) -> bool:
        """True once every rank's clock had passed the window's length at
        the previous step."""
        flag = torch.full((1,), 1.0 if late else 0.0, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        slot = self.n % 2
        self.host[slot:slot + 1].copy_(flag, non_blocking=True)
        evt = None
        if self.cuda:
            evt = torch.cuda.Event()
            evt.record()
        prev, self.prev = self.prev, (evt, slot)
        self.n += 1
        if prev is None:
            return False
        if prev[0] is not None:
            prev[0].synchronize()
        return float(self.host[prev[1]]) > 0


def rank_main(rank: int, world: int, port: int, root: str, workload: str, seed: int,
              seconds: float, traced: bool, device_type: str, t0: float):
    """One rank's run; rank 0 returns the outcome, the others None."""
    from portbench import spec
    cell = spec.load_cell(root, workload)
    device = torch.device(device_type, rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, device_id=device,
                                timeout=GROUP_TIMEOUT)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank, timeout=GROUP_TIMEOUT)
    try:
        return _rank(cell, rank, world, device, seed, seconds, traced, t0)
    finally:
        dist.destroy_process_group()


def _rank(cell, rank, world, device, seed, seconds, traced, t_start):
    mix = cell.mix
    dp = program.data_parallel(rank, world, device)
    b = checked.build(cell, seed, device, dp)
    e = b.cfg.train.tasks_per_batch
    local = e // world
    rec = checked.checked_steps(cell, b, seed, device, rank * local, (rank + 1) * local)
    pool, step, state, n_check = rec.pop("pool"), b.step, b.state, mix["check_steps"]
    flags = EndFlags(device)
    harness.sync(device)
    dist.barrier()
    window_losses = []
    t0 = time.perf_counter()
    n = 0
    while True:
        window_losses.append(program.step_loss(step(state, pool[(n_check + n) % len(pool)])))
        n += 1
        if flags.agreed_late(time.perf_counter() - t0 >= seconds):
            break
    harness.sync(device)
    t1 = time.perf_counter()
    lw = torch.stack(window_losses).double().cpu()
    failed = int((~torch.isfinite(lw)).sum())
    summary = None
    if traced:
        k = mix["trace_steps"]
        dist.barrier()
        summary = trace.tail(lambda: [step(state, pool[i % len(pool)]) for i in range(k)],
                             lambda: step(state, pool[0]), k, device)
    peak = peak_bytes(device)
    fam, shapes = b.fam, b.shapes
    del b, state, pool, step, window_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    w, batches = checked.reference_inputs(cell, fam, shapes, seed, device)
    ref = fam.reference_steps(cell.config, w, batches, seed, replicas=world)
    numbers = check.training(rec, ref, w["model"], fam.HEAD)
    mine = {"rank": rank, "numbers": numbers, "peak": peak, "trace": summary,
            "failed": failed, "steps": n, "window": (t0, t1),
            "setup_s": t0 - t_start, "losses": (rec["losses"], ref["losses"]),
            "forbidden": harness.forbidden_modules()}
    every = [None] * world
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    return _outcome(cell, every, device, e, n)


def _outcome(cell, every, device, e, n):
    worst = {}
    for r in every:
        for k, (v, where) in r["numbers"].items():
            if k not in worst or v > worst[k][0] or not math.isfinite(v):
                worst[k] = (v, f"rank {r['rank']} {where}")
    t0, t1 = every[0]["window"]
    peak = max(r["peak"] for r in every)
    summary = every[0]["trace"]
    if summary is not None:
        summary = dict(summary, busy_s=sum(r["trace"]["busy_s"] for r in every) / len(every),
                       span_s=sum(r["trace"]["span_s"] for r in every) / len(every),
                       ranks=[{k: r["trace"][k] for k in ("busy_s", "span_s")}
                              for r in every])
    info = device_info(device, len(every), peak)
    info["forbidden"] = sorted({m for r in every for m in r["forbidden"]})
    notes = [f"window: {n} steps of {e} episodes over {len(every)} ranks in "
             f"{t1 - t0:.6f} s (rank 0's clock)",
             f"set-up per rank: {[round(r['setup_s'], 3) for r in every]} s; peak per rank "
             f"{[r['peak'] for r in every]} bytes",
             f"checked steps' losses (program, reference): {every[0]['losses']}"]
    return {"setup_s": max(r["setup_s"] for r in every), "window_s": t1 - t0,
            "units": n, "episodes": n * e, "attempted": n,
            "failed": max(r["failed"] for r in every), "peak_bytes": peak,
            "device": info, "trace": summary, "checks": worst, "notes": notes}


def _child(rank, world, port, root, workload, seed, seconds, traced, device_type, t0):
    try:
        rank_main(rank, world, port, root, workload, seed, seconds, traced, device_type, t0)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def run(cell, args) -> dict:
    world = cell.mix["ranks"]
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, world, port, str(cell.root), cell.name,
                                               args.seed, args.seconds, args.trace,
                                               torch.device(args.device).type, args.t0))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = rank_main(0, world, port, str(cell.root), cell.name, args.seed, args.seconds,
                        args.trace, torch.device(args.device).type, args.t0)
    finally:
        for p in procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out

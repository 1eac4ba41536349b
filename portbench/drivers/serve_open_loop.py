"""Serving traffic: one-episode requests arriving as an open loop, scored one
at a time by the scorer that ``cli.export`` and ``cli.demo`` ship
(``tools.aot.make_serving_fn``, eager, in eval mode).

Set-up builds the scorer of the configuration's family with the
benchmark's weights and the state it serves with, makes a pool of
``pool`` requests on the card from the seed and keeps them in pinned host
memory, and serves ``warmup`` requests. Arrivals: Poisson at ``rate_per_s``, the
exponential gaps of a fixed stream (``gaps_seed``) that fall inside the
window, the same schedule for every seed; each arrival takes a pool
request drawn from the seed. A request copies its
clips to the card, is scored, and copies its logits back; its latency runs
from its scheduled arrival to its logits on the host, so a request that
waits behind another counts the wait. Requests due in the window are
served even after it closes, up to a minute; one not answered by then, or
with a non-finite logit, fails and counts at infinity. With ``--trace 1``
``trace_requests`` more are served back to back under the profiler.
Afterwards the reference scores ``check_requests`` of the window's
requests, drawn from the seed, and the largest logit gap is compared.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import check, families, harness, program, trace
from portbench.data import load_
from portbench.drivers.train_step import device_info, peak_bytes

LATE_S = 60.0


def arrivals(rate: float, seconds: float, gaps_seed: int) -> np.ndarray:
    """Arrival times in [0, seconds): Poisson arrivals at ``rate`` from the
    fixed stream ``gaps_seed``, the first at 0. Every seed gets the same
    schedule (a queue's tail follows the order of its gaps); the seed draws
    what each request holds."""
    rng = np.random.default_rng(gaps_seed)
    gaps = rng.exponential(1.0 / rate, size=int(rate * seconds * 2) + 64)
    t = np.concatenate([[0.0], np.cumsum(gaps)])
    return t[t < seconds]


def wait_until(t: float) -> None:
    """Spin until ``t``: a sleeping thread can wake milliseconds late on a
    busy host, and that lateness would reach every request queued behind."""
    while time.perf_counter() < t:
        pass


def serve_window(serve, pool, arr: np.ndarray, picks: np.ndarray, seconds: float):
    """Serve the arrivals; returns per-request (arrival, start, done, out)
    with times relative to the window's start, and that start."""
    t0 = time.perf_counter()
    recs = []
    for a, j in zip(arr, picks):
        if time.perf_counter() - t0 > seconds + LATE_S:
            recs.append((a, math.inf, math.inf, None))
            continue
        wait_until(t0 + a)
        start = time.perf_counter() - t0
        out = serve(pool[j])
        recs.append((a, start, time.perf_counter() - t0, out))
    return recs, t0


def stats(recs, seconds: float) -> dict:
    """Latencies (ms, inf for a request never answered), service seconds,
    the generator's lateness where the server was idle at the arrival, the
    backlog at the close (arrived, not yet started) and the rates."""
    lat, service, late = [], 0.0, []
    prev_done = -math.inf
    for a, start, done, out in recs:
        ok = out is not None and bool(torch.isfinite(out).all())
        lat.append((done - a) * 1e3 if ok else math.inf)
        if math.isfinite(done):
            service += done - start
            if prev_done <= a:
                late.append(start - a)
            prev_done = done
    backlog = sum(1 for a, s, _, _ in recs if a < seconds and s > seconds)
    ends = [d for _, _, d, _ in recs if math.isfinite(d)]
    return {"latencies_ms": lat, "service_s": service,
            "late_mean_s": float(np.mean(late)) if late else 0.0,
            "late_max_s": float(np.max(late)) if late else 0.0,
            "backlog": backlog, "span_s": max(ends) if ends else math.inf,
            "failed": sum(1 for x in lat if not math.isfinite(x))}


def build(cell, args, device):
    """The family, the scorer with the benchmark's weights and the state
    served with (laid alike on both sides), the request pool in host memory
    (pinned on a card) and the serving call."""
    fam = families.load(cell)
    cfg = program.config(cell.config, args.seed)
    program.set_fp32_math()
    module, scorer = fam.scorer(cfg, device)
    shapes = families.shapes({"model": module})
    w = families.draw(shapes, args.seed, device)["model"]
    load_(module, w)
    served = fam.serving_state(cell.config, w, args.seed, device)
    buffers = dict(module.named_buffers())
    with torch.no_grad():
        for n, v in served.items():
            buffers[n].copy_(v)
    del w
    pin = device.type == "cuda"
    pool = []
    for i in range(cell.mix["pool"]):
        ep = fam.episodes(cell.config, args.seed, i, 0, 1, device, train=False)
        req = {k: ep[k] for k in fam.REQUEST}
        pool.append({k: (v.cpu().pin_memory() if pin else v.cpu()) for k, v in req.items()})

    def serve(req):
        with torch.inference_mode():
            out = scorer(*(req[k].to(device, non_blocking=True) for k in fam.REQUEST))
            return out.to("cpu")

    return fam, shapes, served, pool, serve, scorer


def run(cell, args) -> dict:
    device = torch.device(args.device)
    mix = cell.mix
    fam, shapes, served, pool, serve, scorer = build(cell, args, device)
    for j in range(mix.get("warmup", 3)):
        serve(pool[j % len(pool)])
    harness.sync(device)
    arr = arrivals(mix["rate_per_s"], args.seconds, mix["gaps_seed"])
    picks = np.random.default_rng(args.seed + 1).integers(len(pool), size=len(arr))
    recs, t0 = serve_window(serve, pool, arr, picks, args.seconds)
    st = stats(recs, args.seconds)
    summary = None
    if args.trace:
        k = mix["trace_requests"]
        summary = trace.tail(lambda: [serve(pool[i % len(pool)]) for i in range(k)],
                             lambda: serve(pool[0]), k, device)
    peak = peak_bytes(device)
    del scorer, serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    w = families.draw(shapes, args.seed, device)["model"]
    answered = [i for i, r in enumerate(recs) if r[3] is not None]
    rng = np.random.default_rng(args.seed + 2)
    sample = sorted(rng.choice(answered, size=min(mix["check_requests"], len(answered)),
                               replace=False).tolist())
    gap, where = 0.0, ""
    for i in sample:
        ref = fam.reference_score(cell.config, w, served,
                                  {k: v.to(device) for k, v in pool[picks[i]].items()})
        v = check.logit_gap(recs[i][3], ref)
        if v > gap or not math.isfinite(v):
            gap, where = v, f"request {i}"
    t_ref = time.perf_counter() - t_ref
    n = len(recs)
    notes = [f"offered {n} requests at {mix['rate_per_s']} /s over {args.seconds} s; "
             f"completed by {st['span_s']:.6f} s ({n / st['span_s']:.3f} /s); "
             f"backlog at the close {st['backlog']}",
             f"generator lateness (server idle at arrival): mean {st['late_mean_s'] * 1e3:.4f} ms, "
             f"max {st['late_max_s'] * 1e3:.4f} ms",
             f"service: mean {st['service_s'] / max(n - st['failed'], 1) * 1e3:.4f} ms a request; "
             f"p50 {harness.percentile(st['latencies_ms'], 50):.4f} ms",
             f"reference check of {len(sample)} requests: {t_ref:.3f} s"]
    return {"setup_s": t0 - args.t0, "window_s": st["span_s"], "units": n,
            "latencies_ms": st["latencies_ms"], "service_s": st["service_s"],
            "served": n - st["failed"], "attempted": n, "failed": st["failed"],
            "backlog": st["backlog"], "peak_bytes": peak,
            "device": device_info(device, 1, peak), "trace": summary,
            "checks": {"logit_gap": (gap, where)}, "notes": notes}


"""Arithmetic shared by the per-layer readers."""
from __future__ import annotations

from portbench import rooflines


def idle_pct(ctx):
    """100 × (1 − busy / span) of the profiled tail (its device-only
    profile, where that recorded any device event), or None without one."""
    t = ctx["trace"]
    if not t or t["span_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])


def window_idle_pct(ctx, seconds_per_unit: float):
    """100 × (1 − the device's busy time per unit of the profiled tail (its
    device-only profile) over ``seconds_per_unit``, the window's own time
    per step or per request): the share of the untraced window in which
    the card had nothing to run, with the kernels' own time taken from the
    trace. None without a trace."""
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0 or not t["units"] or seconds_per_unit <= 0:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["units"]) / seconds_per_unit)


def tct_roofline_pct(ctx):
    """100 × Σ least time / Σ device time over the forward TCT launches of
    the profiled tail, or None where it has none."""
    t = ctx["trace"]
    if not t or not t["tct"]:
        return None
    bound = sum(rooflines.tct_bound_s(c["shapes"][0], c["shapes"][2]) for c in t["tct"])
    spent = sum(c["kernel_s"] for c in t["tct"])
    return 100.0 * bound / spent if spent > 0 else None


def mfu_pct(ctx, unit: str, seconds_per_unit: float):
    """100 × the least time of the configuration's frozen FLOP count of one
    ``unit`` over the cell's chips, over the measured time of one unit."""
    flops = ctx["cell"].config.get("flops", {}).get(unit)
    if not flops or seconds_per_unit <= 0 or ctx["outcome"]["device"]["platform"] != "gpu":
        return None
    chips = ctx["cell"].chips
    least = rooflines.least_seconds(flops, chips)
    simt = rooflines.simt_seconds(flops, chips)
    ctx["notes"].append(f"{unit}: {sum(flops.values()):.6e} operations ({flops}); "
                        f"{seconds_per_unit * 1e3:.4f} ms a {unit}; share of the fp32-SIMT "
                        f"peak (67 TFLOP/s for fp32) {100.0 * simt / seconds_per_unit:.4f}%")
    return 100.0 * least / seconds_per_unit


def device_ms_per_unit(ctx, seconds):
    t = ctx["trace"]
    if not t or t["units"] <= 0 or seconds <= 0:
        return None
    return 1e3 * seconds / t["units"]

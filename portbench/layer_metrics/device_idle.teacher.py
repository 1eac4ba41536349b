"""Share of the MFM training window in which the card had nothing to run: 1 −
the device's busy time per step, from the profiled tail's device-only
profile (the busy union of kernels and copies over its steps, averaged over
the cell's cards), over the untraced window's time per step."""
from portbench.layer_metrics._shared import window_idle_pct

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "teacher_train_eps_per_s"


def read(ctx):
    o = ctx["outcome"]
    return window_idle_pct(ctx, o["window_s"] / o["units"]) if o.get("units") else None

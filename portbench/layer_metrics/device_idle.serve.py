"""Share of a request's service time in the window (dequeue to logits on the
host, queueing left out, under the cell's own arrivals) in which the card
had nothing to run: 1 − the device's busy time per request, from the
device-only profile of a tail of requests served back to back (the busy
union of kernels and copies), over the window's mean service time."""
from portbench.layer_metrics._shared import window_idle_pct

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "request_ms_p95"


def read(ctx):
    o = ctx["outcome"]
    return window_idle_pct(ctx, o["service_s"] / o["served"]) if o.get("served") else None

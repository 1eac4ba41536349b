"""The served request's share of the card's peak: the configuration's frozen
FLOP count of one request (bf16 at 989 TFLOP/s, fp32 at 495) over the mean
service time of the window's requests, from dequeue to logits on the host,
queueing left out."""
from portbench.layer_metrics._shared import mfu_pct

LAYER = "serving scorer"
UNIT = "%"
BETTER = "higher"
MOVES = "request_ms_p95"


def read(ctx):
    o = ctx["outcome"]
    if not o.get("served"):
        return None
    return mfu_pct(ctx, "serve_request", o["service_s"] / o["served"])

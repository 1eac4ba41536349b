"""The TCT kernel's share of its roofline over the launches of the profiled
serving tail (see ``tct_roofline.train``)."""
from portbench.layer_metrics._shared import tct_roofline_pct

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "request_ms_p95"


def read(ctx):
    return tct_roofline_pct(ctx)

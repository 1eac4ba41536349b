"""The TCT kernel's share of its roofline over the forward launches of the
profiled MFM training tail: Σ max(ops / 495 TFLOP/s, bytes / 3.35 TB/s) over
Σ kernel time (``portbench/rooflines.py``)."""
from portbench.layer_metrics._shared import tct_roofline_pct

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "teacher_train_eps_per_s"


def read(ctx):
    return tct_roofline_pct(ctx)

"""The training step's share of the cards' peak: the configuration's frozen
FLOP count of one step (bf16 operations at 989 TFLOP/s, fp32 at the TF32
495 TFLOP/s, over the cell's cards) over the window's time per step."""
from portbench.layer_metrics._shared import mfu_pct

LAYER = "train steps"
UNIT = "%"
BETTER = "higher"
MOVES = "train_eps_per_s"


def read(ctx):
    o = ctx["outcome"]
    if not o.get("units"):
        return None
    return mfu_pct(ctx, "train_step", o["window_s"] / o["units"])

"""Device ms per training step of the NCCL kernels on rank 0 (the gradient
all-reduce and the metrics' reductions), from the device-only profile."""
from portbench import trace
from portbench.layer_metrics._shared import device_ms_per_unit

LAYER = "distributed training"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_eps_per_s.dp4"


def read(ctx):
    t = ctx["trace"]
    return device_ms_per_unit(ctx, trace.seconds_named(t, "nccl")) if t else None

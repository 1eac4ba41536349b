"""Device ms per training step of the kernels launched inside the program's
``litemkd/optimizer`` span (``zero_grad``, the SGD update and the
schedule's step), from the profile with host activity: a kernel counts
where the innermost program span in its chain of launching host ops is
that one. The optimizer runs on the thread that opens the span, so none of
its kernels is launched from the backward's thread. A device-typed copy of
a host range (named as the first op of its own chain) is no kernel. None
where no kernel has the span in its chain, as in a program without spans."""
from portbench.layer_metrics._shared import device_ms_per_unit
from portbench.spans import innermost_span

LAYER = "train steps"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_eps_per_s"
SPAN = "litemkd/optimizer"


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    mine = [s for name, s, chain in t["kernels"]
            if innermost_span(chain) == SPAN and not (chain and chain[0] == name)]
    return device_ms_per_unit(ctx, sum(mine)) if mine else None

"""Device ms per MFM training step of the kernels launched by matrix products
(mm, addmm, bmm, baddbmm, forward and backward): the fusion encoders' GEMMs,
with the TRX head's linears, a few percent of them."""
from portbench import trace
from portbench.layer_metrics._shared import device_ms_per_unit

LAYER = "fusion encoders"
UNIT = "ms"
BETTER = "lower"
MOVES = "teacher_train_eps_per_s"
OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::addbmm",
       "aten::_addmm_activation")


def read(ctx):
    t = ctx["trace"]
    return device_ms_per_unit(ctx, trace.seconds_under(t, OPS)) if t else None

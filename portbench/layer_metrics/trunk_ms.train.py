"""Device ms per training step of the kernels launched under the trunk's
convolutions and cuDNN BatchNorm, forward and backward (the host ops below
anywhere in a kernel's chain of launching ops)."""
from portbench import trace
from portbench.layer_metrics._shared import device_ms_per_unit

LAYER = "trunks"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_eps_per_s"
OPS = ("aten::convolution", "aten::convolution_backward", "aten::cudnn_convolution",
       "aten::batch_norm", "aten::cudnn_batch_norm", "aten::cudnn_batch_norm_backward",
       "aten::native_batch_norm", "aten::native_batch_norm_backward",
       "aten::_batch_norm_impl_index", "aten::_batch_norm_impl_index_backward")


def read(ctx):
    t = ctx["trace"]
    return device_ms_per_unit(ctx, trace.seconds_under(t, OPS)) if t else None

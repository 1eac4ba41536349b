"""Building blocks of the plain reference: the TRX head with the plain TCT
math, SupportDK, the losses, dropout masks and the precision switch.

Plain PyTorch only. Nothing here imports the program (``litemkd_torch``),
JAX or the JAX package; the formulas are frozen copies of the published
Lite-MKD model as the program documents it, written out op by op.

The truth runs in float32 with TF32 off. The control lowers each part one
step below what the configuration states (:class:`Precision`): a bf16 trunk
becomes fp8 (e4m3 forward, e5m2 gradients, each under a per-tensor scale,
accumulated in fp32) and fp32 products become TF32.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from itertools import combinations
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

@dataclass(frozen=True)
class Precision:
    """``trunk``: "fp32", "bf16" or "fp8": the format of the trunk
    convolutions' operands (:class:`LowConv`); ``tf32``: TF32 in every
    fp32 product."""

    trunk: str = "fp32"
    tf32: bool = False


TRUTH = Precision()
CONTROL = Precision(trunk="fp8", tf32=True)


@contextlib.contextmanager
def precision(prec: Precision):
    """TF32 on or off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    torch.backends.cudnn.allow_tf32 = prec.tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


FORMATS = {"fp8": (torch.float8_e4m3fn, torch.float8_e5m2), "bf16": (torch.bfloat16,) * 2}


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to fp32; an 8-bit float under a
    per-tensor scale that puts amax at the format's largest value."""
    if dtype == torch.bfloat16:
        return x.to(dtype).float()
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class LowConv(torch.autograd.Function):
    """A convolution whose products take their operands in a lower format,
    accumulated in fp32: forward x and w in the format's first dtype, the
    backward's incoming gradient in its second (fp8: e4m3 forward, e5m2
    backward, the usual split), the saved x and w as rounded."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, fmt):
        fwd, bwd = FORMATS[fmt]
        qx, qw = rounded(x, fwd), rounded(w, fwd)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, pad, bwd)
        return F.conv2d(qx, qw, None, stride, pad)

    @staticmethod
    def backward(ctx, gy):
        qx, qw = ctx.saved_tensors
        stride, pad, bwd = ctx.conf
        g = rounded(gy, bwd)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, g, stride, pad) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, g, stride, pad)
        return gx, gw, None, None, None


class Dropout:
    """Inverted dropout whose keep-mask is drawn with ``bernoulli_`` from
    ``generator`` on a tensor laid out as x: the draw the program makes
    (same generator seed, call order, shape and strides give the same
    mask). ``p`` 0 or ``generator`` None: identity."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p = p
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p, generator=self.generator)
        return torch.where(keep.bool(), x / (1.0 - self.p), 0.0)


def sinusoidal_pe(max_len: int, d_model: int, scale: float = 0.1) -> np.ndarray:
    """The TRX positional table, (max_len, d_model), times 0.1."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term) * scale
    pe[:, 1::2] = np.cos(position * div_term) * scale
    return pe


def linear(x, P: Params, prefix: str) -> torch.Tensor:
    return F.linear(x, P[prefix + ".weight"], P[prefix + ".bias"])


def layer_norm(x, P: Params, prefix: str, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[prefix + ".weight"] + P[prefix + ".bias"]


def class_sort(x: torch.Tensor, labels: torch.Tensor, way: int, shot: int):
    """(E, way·shot, ...) rows grouped by label (stable) → (E, way, shot, ...)."""
    order = torch.argsort(labels, dim=-1, stable=True)
    rows = torch.stack([x[e][order[e]] for e in range(x.shape[0])])
    return rows.reshape(x.shape[0], way, shot, *x.shape[2:])


def tct_logits(P: Params, prefix: str, support, labels, queries, way: int,
               shot: int, drop: Dropout, set_size: int = 2) -> torch.Tensor:
    """One temporal cross-transformer: support (E, way·shot, T, D), queries
    (E, Q, T, D) → (E, Q, way) negative mean squared distances between each
    query's tuple values and its class-attended prototype."""
    t, d = support.shape[-2], support.shape[-1]
    pe = torch.from_numpy(sinusoidal_pe(int(t * 1.5), d)).to(support.device)[:t]
    s = drop(support + pe)
    q = drop(queries + pe)
    idx = torch.tensor(list(combinations(range(t), set_size)), device=s.device)
    u = idx.shape[0]
    s_t = s[..., idx, :].reshape(*s.shape[:-2], u, set_size * d)
    q_t = q[..., idx, :].reshape(*q.shape[:-2], u, set_size * d)
    s_k = layer_norm(linear(s_t, P, prefix + ".k_linear"), P, prefix + ".norm_k")
    q_k = layer_norm(linear(q_t, P, prefix + ".k_linear"), P, prefix + ".norm_k")
    s_v = linear(s_t, P, prefix + ".v_linear")
    q_v = linear(q_t, P, prefix + ".v_linear")
    class_k = class_sort(s_k, labels, way, shot)          # (E, W, S, U, dk)
    class_v = class_sort(s_v, labels, way, shot)
    e, nq, _, dk = q_k.shape
    scores = torch.einsum("equd,ewsvd->eqwusv", q_k, class_k) / math.sqrt(dk)
    attn = torch.softmax(scores.reshape(e, nq, way, u, shot * u), dim=-1)
    proto = torch.einsum("eqwuk,ewkd->eqwud", attn,
                         class_v.reshape(e, way, shot * u, dk))
    diff = q_v[:, :, None] - proto
    return -(diff * diff).sum(dim=(-2, -1)) / u


def support_dk(support, labels, way: int, shot: int) -> torch.Tensor:
    """(E, way·shot, T, D) → (E, way, way-1): -‖p_i − p_j‖²_F / T between
    class prototypes (shot means), j ≠ i in ascending order."""
    t = support.shape[-2]
    proto = class_sort(support, labels, way, shot).mean(dim=2)   # (E, W, T, D)
    diff = proto[:, :, None] - proto[:, None, :]
    dist = -(diff * diff).sum(dim=(-2, -1)) / t
    keep = [[j for j in range(way) if j != i] for i in range(way)]
    idx = torch.tensor(keep, device=dist.device)
    return torch.gather(dist, 2, idx.expand(dist.shape[0], -1, -1))


def kd_loss(student, teacher, temperature: float) -> torch.Tensor:
    log_p_s = F.log_softmax(student / temperature, dim=-1)
    p_t = F.softmax(teacher / temperature, dim=-1)
    log_p_t = F.log_softmax(teacher / temperature, dim=-1)
    return (p_t * (log_p_t - log_p_s)).sum(dim=-1).mean() * temperature ** 2


def nll(logits, labels) -> torch.Tensor:
    """Per-row −log softmax at the label."""
    return -torch.gather(F.log_softmax(logits, dim=-1), -1,
                         labels.long()[..., None])[..., 0]


def inter_class_relation(y_s, y_t, eps: float = 1e-8) -> torch.Tensor:
    """DIST: 1 − mean row-wise Pearson correlation of the softmaxed rows."""
    a, b = F.softmax(y_s, dim=1), F.softmax(y_t, dim=1)
    ac = a - a.mean(dim=1, keepdim=True)
    bc = b - b.mean(dim=1, keepdim=True)
    na = torch.sqrt((ac * ac).sum(dim=1) + 1e-16)
    nb = torch.sqrt((bc * bc).sum(dim=1) + 1e-16)
    return 1.0 - ((ac * bc).sum(dim=1) / (na * nb + eps)).mean()


def sgd_(params: Params, grads: Params, lr: float) -> None:
    """Plain SGD without momentum, p ← p − lr·g, in place."""
    with torch.no_grad():
        for n, g in grads.items():
            params[n].add_(g, alpha=-lr)

"""Training-mode BatchNorm with kernel-reduced moments (port of
``litemkd_tpu/ops/pallas_bn.py``).

Two hand-written CUDA kernels (``csrc/bn_moments.cu``) replace the TPU
kernels ``_sums_pallas`` and ``_bwd_sums_pallas``: column sums of a
channels-last (R, C) activation, bf16 or fp32 in, fp32 out. Both are bound
by the bytes they read; the source note says how the design answers that.

- :func:`bn_sums` (R, C) x → (2, C) [Σx, Σx²];
- :func:`bn_bwd_sums` (R, C) dy and x, per-channel μ and σ⁻¹ → (2, C)
  [Σdy, Σdy·x̂].

Beside each kernel is its plain PyTorch version (``bn_sums_plain``,
``bn_bwd_sums_plain``: the math of ``_sums_jnp`` and ``_bwd_sums_jnp``).
Each pair sits behind one ``torch.library`` custom op, ``litemkd::bn_sums``
and ``litemkd::bn_bwd_sums``, with a fake implementation, so that every
kernel wrapper of the port can be traced: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises (a dtype other than
bf16/fp32, a non-contiguous view). There is no fallback and no switch.
Each launch adds one to ``bn_sums.launches`` or ``bn_bwd_sums.launches``.

:func:`batch_norm_train` is the autograd Function of the JAX package's
custom-VJP ``batch_norm_train`` (``pallas_bn.py:156-201``). The
normalize/apply and dx stay plain PyTorch, as the JAX package left them to
XLA: μ, σ⁻¹, γ and β are folded into one per-channel scale and shift before
x is touched. In eager mode that is still a few passes over x: forward an
fp32 copy of x, the scaled product and the cast back to x's dtype (two fp32
temporaries of R·C floats at a bf16 trunk, 2 × 5.1 GB at the flagship stem);
backward three passes to build dx. Fusing them is later work.

Data-parallel training over several ranks (:func:`synced_moments`) sums the
kernels' per-channel outputs over the ranks that hold one micro-batch chunk
before they are used, so one BatchNorm batch may span several ranks' rows
(:class:`Span`).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from ._build import library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bn_sums_plain(x2: torch.Tensor) -> torch.Tensor:
    """(R, C) → (2, C) fp32 [Σx, Σx²] (``_sums_jnp``)."""
    xf = x2.to(torch.float32)
    return torch.stack([xf.sum(dim=0), (xf * xf).sum(dim=0)])


def bn_bwd_sums_plain(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor) -> torch.Tensor:
    """(R, C) dy and x, (C,) μ and σ⁻¹ → (2, C) fp32 [Σdy, Σdy·x̂]
    (``_bwd_sums_jnp``)."""
    dy = dy2.to(torch.float32)
    xhat = (x2.to(torch.float32) - mean) * inv
    return torch.stack([dy.sum(dim=0), (dy * xhat).sum(dim=0)])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("bn_moments")
    lib.bn_moments_workspace_floats.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                                ctypes.c_int]
    lib.bn_moments_workspace_floats.restype = ctypes.c_longlong
    lib.bn_sums.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 3
                            + [ctypes.c_void_p] * 3)
    lib.bn_sums.restype = ctypes.c_int
    lib.bn_bwd_sums.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.bn_bwd_sums.restype = ctypes.c_int
    return lib


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name} must be a non-empty (R, C) matrix, got "
                         f"{tuple(t.shape)}")


def _check_cuda(tensors) -> int:
    """Dtype code of the (R, C) operands, which must share it and be
    contiguous; raises on anything the kernels do not take."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"the BN kernels take float32 or bfloat16, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"operands differ in dtype: {t.dtype} != {dtype}")
        if not t.is_contiguous():
            raise ValueError("the BN kernels take a contiguous (R, C) view")
    return _DTYPES[dtype]


def _vec(tensors, c: int) -> int:
    """Elements per load: one 16-byte word where C and the base addresses
    allow, else one element (ragged C)."""
    v = 16 // tensors[0].element_size()
    if c % v == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return v
    return 1


def _same_device(*tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the BN sums run on cpu or cuda, not {device}")
    return device


def _workspace(lib, r: int, c: int, vec: int, device) -> torch.Tensor:
    n = lib.bn_moments_workspace_floats(r, c, vec)
    if n <= 0:
        raise ValueError(f"no kernel geometry for R={r}, C={c}, vec={vec}")
    return torch.empty(n, dtype=torch.float32, device=device)


@torch.library.custom_op("litemkd::bn_sums", mutates_args=(),
                         device_types="cpu")
def _bn_sums_op(x2: torch.Tensor) -> torch.Tensor:
    return bn_sums_plain(x2)


@_bn_sums_op.register_fake
def _bn_sums_fake(x2):
    return x2.new_empty((2, x2.shape[1]), dtype=torch.float32)


@_bn_sums_op.register_kernel("cuda")
def _bn_sums_cuda(x2):
    r, c = x2.shape
    dtype = _check_cuda([x2])
    vec = _vec([x2], c)
    lib = _library()
    ws = _workspace(lib, r, c, vec, x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.bn_sums(x2.data_ptr(), r, c, dtype, vec, ws.data_ptr(),
                          out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_sums kernel launch failed: CUDA error {err}")
    bn_sums.launches += 1
    return out


def bn_sums(x2: torch.Tensor) -> torch.Tensor:
    """(R, C) → (2, C) fp32 [Σx, Σx²] through ``litemkd::bn_sums``. CPU:
    :func:`bn_sums_plain`; CUDA: the kernel (bf16 or fp32, contiguous, or
    this raises)."""
    _check_rows("x", x2)
    _same_device(x2)
    return torch.ops.litemkd.bn_sums(x2)


@torch.library.custom_op("litemkd::bn_bwd_sums", mutates_args=(),
                         device_types="cpu")
def _bn_bwd_sums_op(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                    inv: torch.Tensor) -> torch.Tensor:
    return bn_bwd_sums_plain(dy2, x2, mean, inv)


@_bn_bwd_sums_op.register_fake
def _bn_bwd_sums_fake(dy2, x2, mean, inv):
    return x2.new_empty((2, x2.shape[1]), dtype=torch.float32)


@_bn_bwd_sums_op.register_kernel("cuda")
def _bn_bwd_sums_cuda(dy2, x2, mean, inv):
    r, c = x2.shape
    dtype = _check_cuda([dy2, x2])
    for name, t in (("mean", mean), ("inv", inv)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
    vec = _vec([dy2, x2], c)
    lib = _library()
    ws = _workspace(lib, r, c, vec, x2.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = lib.bn_bwd_sums(dy2.data_ptr(), x2.data_ptr(), mean.data_ptr(),
                              inv.data_ptr(), r, c, dtype, vec, ws.data_ptr(),
                              out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bn_bwd_sums kernel launch failed: CUDA error {err}")
    bn_bwd_sums.launches += 1
    return out


def bn_bwd_sums(dy2: torch.Tensor, x2: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """(R, C) dy and x, (C,) fp32 μ and σ⁻¹ → (2, C) fp32 [Σdy, Σdy·x̂]
    through ``litemkd::bn_bwd_sums``. CPU: :func:`bn_bwd_sums_plain`; CUDA:
    the kernel (dy and x of one dtype, bf16 or fp32, contiguous, or this
    raises)."""
    _check_rows("x", x2)
    if dy2.shape != x2.shape:
        raise ValueError(f"dy {tuple(dy2.shape)} != x {tuple(x2.shape)}")
    c = x2.shape[1]
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    _same_device(dy2, x2, mean, inv)
    return torch.ops.litemkd.bn_bwd_sums(dy2, x2, mean, inv)


bn_sums.launches = 0
bn_bwd_sums.launches = 0


class Span(NamedTuple):
    """A BatchNorm batch whose rows lie on several ranks: their process
    ``group`` (None: the default group), and the episodes of the batch on
    this rank (``here``) and on all of them (``total``). Every episode
    gives the same number of rows, so the batch has R·total/here rows for
    R here."""

    group: object
    here: int
    total: int


def _batch_rows(x2: torch.Tensor, span: Optional[Span]) -> int:
    r = x2.shape[0]
    if span is None:
        return r
    if r % span.here:
        raise ValueError(f"{r} rows are not {span.here} episodes' worth")
    return r // span.here * span.total


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, weight, bias, eps, span):
        r = _batch_rows(x2, span)
        sums = bn_sums(x2)
        if span is not None:
            dist.all_reduce(sums, group=span.group)
        mean = sums[0] / r
        var = torch.clamp_min(sums[1] / r - mean * mean, 0.0)  # E[x²]−E[x]²
        inv = torch.rsqrt(var + eps)
        scale = weight.to(torch.float32) * inv
        shift = bias.to(torch.float32) - mean * scale
        y = (x2.to(torch.float32) * scale).add_(shift).to(x2.dtype)
        ctx.save_for_backward(x2, weight, mean, inv)
        ctx.span = span
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x2, weight, mean, inv = ctx.saved_tensors
        r = _batch_rows(x2, ctx.span)
        gy = gy.contiguous()
        sums = bn_bwd_sums(gy, x2, mean, inv)
        # γ and β get this rank's share (the ranks' gradients are summed
        # afterwards); dx needs the sums over the batch's rows on every rank
        local = sums
        if ctx.span is not None:
            sums = sums.clone()
            dist.all_reduce(sums, group=ctx.span.group)
        s_dy, s_dyxh = sums[0], sums[1]
        # dx = γσ⁻¹(dy − Σdy/R − x̂·Σdy·x̂/R) = a·dy + b·x + c per channel
        a = weight.to(torch.float32) * inv
        b = -a * inv * s_dyxh / r
        c = -a * s_dy / r - b * mean
        dx = (gy.to(torch.float32) * a).add_(x2.to(torch.float32) * b)
        dx = dx.add_(c).to(x2.dtype)
        return (dx, local[1].to(weight.dtype), local[0].to(weight.dtype),
                None, None)


def batch_norm_train(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5, *, span: Optional[Span] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN of a channels-last (R, C) activation → ``(y, batch
    mean, biased batch var)``. y has x's dtype; mean and var are fp32 and
    carry no gradient (they feed the running-stat update). The moments come
    from :func:`bn_sums` / :func:`bn_bwd_sums` (the kernels on the card).

    With a ``span`` the batch is the rows of every rank of its group, so
    both moment sums are summed over them before use (a synchronised
    BatchNorm) and the row count is the batch's; γ and β get this rank's
    share of their gradient."""
    return _BatchNormTrain.apply(x2, weight, bias, eps, span)


@contextlib.contextmanager
def synced_moments(model: nn.Module, span: Optional[Span] = None,
                   keep_stats: bool = True):
    """Within this block every :class:`BatchNorm` of ``model`` that takes
    batch moments in training takes them over ``span``
    (:func:`batch_norm_train`; None leaves them local) and, with
    ``keep_stats`` False, leaves its running statistics as they are. The
    data-parallel train step enters it for each piece of a micro-batch
    chunk, forward and backward both: a piece of a chunk over several
    replicas with the chunk's span, and on all but the chunk's first
    replica without keeping the update, which that one keeps."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.span, m.keep_stats = span, keep_stats
    try:
        yield
    finally:
        for m in bns:
            m.span, m.keep_stats = None, True


def channels_last_rows(x: torch.Tensor) -> torch.Tensor:
    """The (N·H·W, C) rows of an NCHW tensor held in channels-last memory,
    as a view. Raises where that view would need a copy."""
    n, c, h, w = x.shape
    nhwc = x.permute(0, 2, 3, 1)
    if not nhwc.is_contiguous():
        raise ValueError(f"BatchNorm input {tuple(x.shape)} is not in "
                         "channels-last memory; the trunk keeps it there")
    return nhwc.view(n * h * w, c)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with the JAX package's training semantics
    (``PallasBatchNorm`` and flax ``nn.BatchNorm``, momentum 0.9).

    - ``pallas_bn``: training moments come from :func:`bn_sums` /
      :func:`bn_bwd_sums` through :func:`batch_norm_train`; otherwise
      ``F.batch_norm`` (cuDNN on the card).
    - ``freeze_bn``: training uses the running statistics and updates none.
    - ``span`` (set by :func:`synced_moments`): the training moments are
      those of the rows of every rank of the span, through
      :func:`batch_norm_train` and so the BN-moment kernels on the card
      whether or not ``pallas_bn`` is set (cuDNN's BatchNorm cannot sum
      over the ranks). ``keep_stats`` False: the running statistics and
      the update count stay as they are (another rank keeps the update).
    - Running variance: updated with the **biased** batch variance on both
      paths, as flax and ``PallasBatchNorm`` do (PARITY.md:123-124). torch
      updates with the unbiased one; on the ``F.batch_norm`` path the
      update is corrected per channel, rv = (1−m)·rv_old + (rv_torch −
      (1−m)·rv_old)·(n−1)/n with n = N·H·W and m the momentum.
    - ``recomputing``: set while a rematerialized block runs its forward
      again in the backward pass (``ResNetTrunk(remat=True)``); that run
      computes the same batch statistics and updates nothing, as flax's
      remat discards the mutation of its recompute.
    The parameters and buffers keep ``nn.BatchNorm2d``'s names, so
    reference-layout state dicts load unchanged; ``momentum`` is torch's
    (0.1 for flax's 0.9; the MobileNetV3 trunk's 0.01 for flax's 0.99)."""

    def __init__(self, channels: int, eps: float = 1e-5, pallas_bn: bool = False,
                 freeze_bn: bool = False, momentum: float = 0.1):
        super().__init__(channels, eps=eps, momentum=momentum)
        self.pallas_bn = pallas_bn
        self.freeze_bn = freeze_bn
        self.recomputing = False
        self.span: Optional[Span] = None
        self.keep_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.freeze_bn:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        update = self.keep_stats and not self.recomputing
        if update:
            self.num_batches_tracked.add_(1)
        m = self.momentum
        if self.pallas_bn or self.span is not None:
            n, c, h, w = x.shape
            # the synced path without pallas_bn takes any memory format: the
            # rows are a view in channels-last memory, else a copy
            rows = (channels_last_rows(x) if self.pallas_bn
                    else x.permute(0, 2, 3, 1).reshape(n * h * w, c))
            y, mean, var = batch_norm_train(rows, self.weight, self.bias,
                                            self.eps, span=self.span)
            if update:
                with torch.no_grad():
                    self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                    self.running_var.mul_(1 - m).add_(var, alpha=m)
            return y.view(n, h, w, c).permute(0, 3, 1, 2)
        # F.batch_norm updates copies (the op keeps them for its backward,
        # so the buffers themselves must not change under it)
        n = x.numel() // x.shape[1]
        rm, rv = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, rm, rv, self.weight, self.bias, True, m, self.eps)
        if not update:
            return y
        with torch.no_grad():
            keep = self.running_var * (1 - m)
            self.running_mean.copy_(rm)
            self.running_var.copy_((rv - keep) * ((n - 1) / n) + keep)
        return y

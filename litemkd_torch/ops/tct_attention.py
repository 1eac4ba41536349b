"""The TRX cross-attention core: a hand-written CUDA kernel and its plain
PyTorch version.

For every episode e, query q and class w::

    scores = q_k[e,q] · class_k[e,w]^T / sqrt(dk)   over the joint (shot × tuple) axis
    attn   = row-softmax(scores)
    proto  = attn · class_v[e,w]
    logits[e,q,w] = -Σ_u ‖q_v[e,q,u] - proto[u]‖² / U

The kernel (``csrc/tct_attention.cu``) replaces the TPU kernel
``litemkd_tpu/ops/pallas_tct.py:_kernel``. Its source note says what bounds
it on an H100 and how the design answers that. It is built with nvcc at
first use into ``litemkd_torch/_build/`` (keyed by a hash of the source) and
loaded with ctypes.

:func:`tct_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises: there is no
fallback from CUDA to the plain version and no switch that forces it.
``model.use_pallas`` has no effect on this choice.

On CUDA the kernel runs inside a ``torch.autograd.Function``, so the logits
carry a gradient. Its backward recomputes through the plain version
(:func:`tct_attention_backward_plain`), as the JAX package's custom VJP
recomputes through ``tct_attention_xla`` (``pallas_tct.py:168-172``): the
JAX package has no backward kernel for this op.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import library
from .dtypes import anchor_dtype


def tct_attention_plain(q_k, q_v, class_k, class_v, return_proto: bool = False):
    """Plain PyTorch version, the math of ``tct_attention_xla``
    (``litemkd_tpu/ops/pallas_tct.py:139-155``) with an episode axis.

    q_k, q_v (E, Q, U, dk); class_k, class_v (E, W, S, U, dk) → logits
    (E, Q, W), and with ``return_proto`` also the (E, Q, W, U, dk)
    prototypes."""
    e, q, u, dk = q_k.shape
    w, s = class_k.shape[1], class_k.shape[2]
    acc = anchor_dtype(q_k.dtype)
    scores = torch.einsum("equd,ewsvd->eqwusv", q_k.to(acc),
                          class_k.to(acc)) / float(dk) ** 0.5
    attn = torch.softmax(scores.reshape(e, q, w, u, s * u), dim=-1)
    attn = attn.reshape(e, q, w, u, s, u)
    proto = torch.einsum("eqwusv,ewsvd->eqwud", attn, class_v.to(acc))
    diff = q_v.to(acc)[:, :, None] - proto
    dist = (diff * diff).sum(dim=(-2, -1)) / u
    return (-dist, proto) if return_proto else -dist


def tct_attention_backward_plain(g, q_k, q_v, class_k, class_v):
    """Gradients of ``Σ g · tct_attention_plain(q_k, q_v, class_k, class_v)``
    with respect to the four operands, by autograd through the plain
    version: the counterpart of ``jax.vjp(tct_attention_xla)``."""
    with torch.enable_grad():
        ops = [t.detach().requires_grad_(True)
               for t in (q_k, q_v, class_k, class_v)]
        out = tct_attention_plain(*ops)
        return torch.autograd.grad(out, ops, g)


class _TCTAttention(torch.autograd.Function):
    """The CUDA kernel forward; backward by plain recompute."""

    @staticmethod
    def forward(ctx, q_k, q_v, class_k, class_v):
        ctx.save_for_backward(q_k, q_v, class_k, class_v)
        return _launch(q_k, q_v, class_k, class_v)

    @staticmethod
    def backward(ctx, g):
        return tct_attention_backward_plain(g, *ctx.saved_tensors)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("tct_attention")
    lib.tct_attention_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.tct_attention_forward.restype = ctypes.c_int
    lib.tct_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tct_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(q_k, q_v, class_k, class_v) -> None:
    if q_k.dim() != 4 or class_k.dim() != 5:
        raise ValueError(f"expected q_k (E, Q, U, dk) and class_k "
                         f"(E, W, S, U, dk), got {tuple(q_k.shape)} and "
                         f"{tuple(class_k.shape)}")
    e, _, u, dk = q_k.shape
    if q_v.shape != q_k.shape:
        raise ValueError(f"q_v {tuple(q_v.shape)} != q_k {tuple(q_k.shape)}")
    if class_v.shape != class_k.shape:
        raise ValueError(f"class_v {tuple(class_v.shape)} != class_k "
                         f"{tuple(class_k.shape)}")
    if class_k.shape[0] != e or class_k.shape[3] != u or class_k.shape[4] != dk:
        raise ValueError(f"class_k {tuple(class_k.shape)} does not match "
                         f"q_k {tuple(q_k.shape)}")
    devices = {t.device for t in (q_k, q_v, class_k, class_v)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _launch(q_k, q_v, class_k, class_v) -> torch.Tensor:
    for name, t in (("q_k", q_k), ("q_v", q_v), ("class_k", class_k),
                    ("class_v", class_v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    e, q, u, dk = q_k.shape
    w, s = class_k.shape[1], class_k.shape[2]
    if dk == 0 or u == 0:
        raise ValueError(f"empty tuple or feature axis: U={u}, dk={dk}")
    lib = _library()
    if lib.tct_attention_smem_bytes(s, u) == 0:
        raise ValueError(f"S={s}, U={u}: the score tile does not fit the "
                         "kernel's shared memory or registers")
    out = torch.empty((e, q, w), dtype=torch.float32, device=q_k.device)
    with torch.cuda.device(q_k.device):
        stream = torch.cuda.current_stream(q_k.device).cuda_stream
        err = lib.tct_attention_forward(
            q_k.data_ptr(), q_v.data_ptr(), class_k.data_ptr(),
            class_v.data_ptr(), out.data_ptr(), e, q, w, s, u, dk, stream)
    if err != 0:
        raise RuntimeError(f"tct_attention kernel launch failed: CUDA error {err}")
    tct_attention.launches += 1
    return out


def tct_attention(q_k, q_v, class_k, class_v) -> torch.Tensor:
    """q_k, q_v (E, Q, U, dk); class_k, class_v (E, W, S, U, dk) → logits
    (E, Q, W) fp32.

    CPU tensors go through :func:`tct_attention_plain`. CUDA tensors launch
    the kernel (fp32 and contiguous, or this raises) inside an autograd
    Function whose backward recomputes through the plain version. Every
    launch adds one to ``tct_attention.launches``."""
    _check(q_k, q_v, class_k, class_v)
    if q_k.device.type == "cpu":
        return tct_attention_plain(q_k, q_v, class_k, class_v)
    if q_k.device.type != "cuda":
        raise ValueError(f"tct_attention runs on cpu or cuda, not {q_k.device}")
    return _TCTAttention.apply(q_k, q_v, class_k, class_v)


tct_attention.launches = 0

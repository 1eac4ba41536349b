"""The TRX cross-attention core: a hand-written CUDA kernel and its plain
PyTorch version.

For every episode e, query q and class w::

    scores = q_k[e,q] · class_k[e,w]^T / sqrt(dk)   over the joint (shot × tuple) axis
    attn   = row-softmax(scores)
    proto  = attn · class_v[e,w]
    logits[e,q,w] = -Σ_u ‖q_v[e,q,u] - proto[u]‖² / U

The kernel (``csrc/tct_attention.cu``) replaces the TPU kernel
``litemkd_tpu/ops/pallas_tct.py:_kernel``. Its source note says what bounds
it on an H100 and how the design answers that: both products on the tensor
cores in split TF32, one block per (episode, class, group of G queries). It
is built with nvcc at first use into ``litemkd_torch/_build/`` (keyed by a
hash of the source) and loaded with ctypes. The wrapper picks G
(:func:`group_size`) and the kernel's 16-byte copies where dk % 4 == 0 and
every operand is 16-byte aligned (4-byte copies otherwise), and raises
before any launch on a shape whose tiles do not fit shared memory.

:func:`tct_attention` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises: there is no
fallback from CUDA to the plain version and no switch that forces it.
``model.use_pallas`` has no effect on this choice.

Both routes sit behind one ``torch.library`` custom op,
``litemkd::tct_attention``: its CPU implementation is the plain version,
its CUDA implementation the kernel's launch, and its fake implementation
gives the (E, Q, W) shape, so ``torch.export`` keeps the op as one node of
the graph (neither the plain math inlined nor a ctypes call traced) and an
exported program launches the kernel on the card. The op's autograd
formula recomputes through the plain version
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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = library("tct_attention")
    lib.tct_attention_forward.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.tct_attention_forward.restype = ctypes.c_int
    lib.tct_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
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


GROUPS = (1, 2, 4)


def group_size(e: int, q: int, w: int, n_sm: int) -> int:
    """Queries per kernel block, G in :data:`GROUPS`, for E episodes of Q
    queries and W classes on a card of ``n_sm`` SMs.

    A block of G queries reads its class tile once for G queries, so a
    larger G moves fewer bytes, but it makes fewer, longer blocks. The cost
    counted is waves × (G + 1): waves of E·W·⌈Q/G⌉ blocks at two blocks an
    SM, each block's time as its G queries' products plus about one query's
    worth for the class tile. The least cost wins; a tie goes to the larger
    G. No G exceeds Q."""
    def cost(g):
        blocks = e * w * -(-q // g)
        return -(-blocks // (2 * n_sm)) * (g + 1)
    return min((g for g in GROUPS if g <= max(q, 1)),
               key=lambda g: (cost(g), -g))


def _launch(q_k, q_v, class_k, class_v, group=None) -> torch.Tensor:
    """Launch the kernel with ``group`` queries per block, by default
    :func:`group_size`'s choice (halved while it does not fit shared
    memory). Raises before any launch on what the kernel does not take."""
    for name, t in (("q_k", q_k), ("q_v", q_v), ("class_k", class_k),
                    ("class_v", class_v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the CUDA kernel, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    e, q, u, dk = q_k.shape
    w, s = class_k.shape[1], class_k.shape[2]
    if dk == 0 or u == 0 or s == 0:
        raise ValueError(f"empty tuple, shot or feature axis: U={u}, S={s}, "
                         f"dk={dk}")
    lib = _library()
    if group is None:
        n_sm = torch.cuda.get_device_properties(q_k.device).multi_processor_count
        group = group_size(e, q, w, n_sm)
        while group > 1 and lib.tct_attention_smem_bytes(s, u, group) == 0:
            group //= 2
    if group < 1 or lib.tct_attention_smem_bytes(s, u, group) == 0:
        raise ValueError(f"S={s}, U={u}, G={group}: the score tile does not "
                         "fit the kernel's shared memory")
    ops = (q_k, q_v, class_k, class_v)
    vec16 = dk % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ops)
    out = torch.empty((e, q, w), dtype=torch.float32, device=q_k.device)
    with torch.cuda.device(q_k.device):
        stream = torch.cuda.current_stream(q_k.device).cuda_stream
        err = lib.tct_attention_forward(
            *(t.data_ptr() for t in ops), out.data_ptr(), e, q, w, s, u, dk,
            group, int(vec16), stream)
    if err != 0:
        raise RuntimeError(f"tct_attention kernel launch failed: CUDA error {err}")
    tct_attention.launches += 1
    return out


@torch.library.custom_op("litemkd::tct_attention", mutates_args=(),
                         device_types="cpu")
def _tct_attention_op(q_k: torch.Tensor, q_v: torch.Tensor,
                      class_k: torch.Tensor, class_v: torch.Tensor
                      ) -> torch.Tensor:
    return tct_attention_plain(q_k, q_v, class_k, class_v)


@_tct_attention_op.register_kernel("cuda")
def _tct_attention_cuda(q_k, q_v, class_k, class_v):
    return _launch(q_k, q_v, class_k, class_v)


@_tct_attention_op.register_fake
def _tct_attention_fake(q_k, q_v, class_k, class_v):
    return q_k.new_empty((q_k.shape[0], q_k.shape[1], class_k.shape[1]),
                         dtype=anchor_dtype(q_k.dtype))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
    return tct_attention_backward_plain(g, *ctx.saved_tensors)


_tct_attention_op.register_autograd(_backward, setup_context=_setup_context)


def tct_attention(q_k, q_v, class_k, class_v) -> torch.Tensor:
    """q_k, q_v (E, Q, U, dk); class_k, class_v (E, W, S, U, dk) → logits
    (E, Q, W) in the anchor dtype of q_k (fp32 on the card).

    Calls the op ``litemkd::tct_attention``: CPU tensors go through
    :func:`tct_attention_plain`, CUDA tensors launch the kernel (fp32 and
    contiguous, or this raises); the backward recomputes through the plain
    version on both. Every launch adds one to ``tct_attention.launches``."""
    _check(q_k, q_v, class_k, class_v)
    if q_k.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tct_attention runs on cpu or cuda, not {q_k.device}")
    return torch.ops.litemkd.tct_attention(q_k, q_v, class_k, class_v)


tct_attention.launches = 0

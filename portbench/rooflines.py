"""The yardstick: one H100's published peaks and the operations and bytes of
the hand-written kernels, frozen here so that a change to the program cannot
move them.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
bf16, 495 TFLOP/s TF32 (the fastest tensor-core rate at which an fp32
product can be computed, so no fp32-accurate implementation reads over
100% of it), 67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s of HBM.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"bf16": 989e12, "fp32": 495e12}
FP32_SIMT_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def tct_ops(q_k_shape: Sequence[int], class_k_shape: Sequence[int]) -> int:
    """Operations of one ``litemkd::tct_attention`` call, q_k (E, Q, U, dk)
    and class_k (E, W, S, U, dk): the scores q_k·class_kᵀ over the joint
    (shot × tuple) axis and the prototypes attn·class_v, 2 per multiply-add
    each: 2·2·E·Q·W·U·(S·U)·dk."""
    e, q, u, dk = q_k_shape
    w, s = class_k_shape[1], class_k_shape[2]
    return 2 * 2 * e * q * w * u * (s * u) * dk


def tct_bytes(q_k_shape: Sequence[int], class_k_shape: Sequence[int],
              itemsize: int = 4) -> int:
    """Bytes the call must move: q_k, q_v, class_k and class_v read once and
    the (E, Q, W) logits written once, fp32."""
    e, q, u, dk = q_k_shape
    w, s = class_k_shape[1], class_k_shape[2]
    return itemsize * (2 * e * q * u * dk + 2 * e * w * s * u * dk + e * q * w)


def tct_bound_s(q_k_shape, class_k_shape) -> float:
    """The least time the card could take for one call: the larger of its
    operations at the TF32 rate and its bytes at the HBM rate."""
    return max(tct_ops(q_k_shape, class_k_shape) / PEAK_FLOPS["fp32"],
               tct_bytes(q_k_shape, class_k_shape) / HBM_BYTES_PER_S)


def least_seconds(flops: Dict[str, float], chips: int = 1) -> float:
    """The least time ``chips`` cards could take for ``flops`` (operand
    dtype → operations), each dtype at its peak."""
    return sum(n / PEAK_FLOPS[k] for k, n in flops.items()) / chips


def simt_seconds(flops: Dict[str, float], chips: int = 1) -> float:
    """The same with fp32 at the fp32 SIMT peak (printed beside, not a
    metric)."""
    return sum(n / (PEAK_FLOPS[k] if k != "fp32" else FP32_SIMT_FLOPS)
               for k, n in flops.items()) / chips

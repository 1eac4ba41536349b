"""Numerics-anchor dtype policy (port of ``litemkd_tpu/ops/dtypes.py``).

"bf16 trunks / fp32 stats-softmax-logits": precision-sensitive reductions are
pinned to float32, while float64 flows stay float64.
"""
from __future__ import annotations

import torch


def anchor_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 anchor for sub-fp32 dtypes; float64 stays float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def anchor(x: torch.Tensor) -> torch.Tensor:
    """Cast ``x`` up to its anchor dtype (bf16/fp16/fp32 → fp32, fp64 → fp64)."""
    return x.to(anchor_dtype(x.dtype))


def set_fp32_math() -> None:
    """Full fp32 in matrix products and convolutions (no TF32), so fp32
    results match the JAX package's highest-precision reference. The entry
    points and the artifact loader call this; bf16 trunks are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

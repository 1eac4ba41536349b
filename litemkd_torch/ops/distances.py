"""SupportDK, the support-level relation head, and the gradient-safe norm
(port of ``litemkd_tpu/ops/distances.py:22-42, 68-73``)."""
from __future__ import annotations

import numpy as np
import torch

from .dtypes import anchor
from .tct import class_sort


def _off_diag(way: int) -> np.ndarray:
    """(way, way-1) column indices skipping the diagonal."""
    return np.stack([[j for j in range(way) if j != i] for i in range(way)])


def support_dk_logits(support: torch.Tensor, support_labels: torch.Tensor,
                      way: int, shot: int, seq_len: int) -> torch.Tensor:
    """(E, way·shot, T, D) support, (E, way·shot) labels → (E, way, way-1)
    negative mean-squared distances between class prototypes.

    Row i lists -‖p_i - p_j‖²_F / seq_len for j ≠ i in ascending class
    order, the reference's nested-loop fill order."""
    s = class_sort(support, support_labels, way, shot)   # (E, W, S, T, D)
    proto = anchor(s.mean(dim=2))                         # (E, W, T, D)
    diff = proto[:, :, None] - proto[:, None, :]          # (E, W, W, T, D)
    dist = -(diff * diff).sum(dim=(-2, -1)) / seq_len
    idx = torch.from_numpy(_off_diag(way)).to(dist.device)
    return torch.gather(dist, 2, idx.expand(dist.shape[0], -1, -1))


def safe_norm(x: torch.Tensor, axis=-1, keepdims: bool = False) -> torch.Tensor:
    """``sqrt(sum(x²) + 1e-16)``: an L2 norm whose gradient is finite at
    exactly zero (``torch.linalg.norm``'s is NaN there)."""
    return torch.sqrt((x * x).sum(dim=axis, keepdim=keepdims) + 1e-16)

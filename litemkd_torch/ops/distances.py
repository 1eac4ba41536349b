"""SupportDK, the support-level relation head, the prototype matchers of
the e_dist/cos heads, and the gradient-safe norm (port of
``litemkd_tpu/ops/distances.py:22-84``).

The matchers take an explicit leading episode axis E, like every head of
the port."""
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


def _cdist(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise euclidean distance (..., Q, D) × (..., S, D) → (..., Q, S)
    as ``sqrt(max(‖a‖² + ‖b‖² − 2ab, eps))``, the JAX package's formula
    (``torch.cdist`` rounds otherwise and has another gradient at 0)."""
    aa = (a * a).sum(dim=-1, keepdim=True)
    bb = (b * b).sum(dim=-1)
    sq = aa + bb[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))
    return torch.sqrt(torch.clamp(sq, min=eps))


def edist_logits(support: torch.Tensor, support_labels: torch.Tensor,
                 queries: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """(E, way·shot, T, D) support, (E, Q, T, D) queries → (E, Q, way):
    frame-mean embeddings, and for class w the NEGATIVE MEAN of the
    distances to that class's shot embeddings (the reference averages the
    cdist row, not the prototypes)."""
    q = anchor(queries.mean(dim=-2))                              # (E, Q, D)
    s = anchor(class_sort(support, support_labels, way, shot).mean(dim=-2))
    e = s.shape[0]
    d = _cdist(q, s.reshape(e, way * shot, -1))                   # (E, Q, WS)
    return -d.reshape(e, -1, way, shot).mean(dim=-1)


def cosine_logits(support: torch.Tensor, support_labels: torch.Tensor,
                  queries: torch.Tensor, way: int, shot: int,
                  eps: float = 1e-8) -> torch.Tensor:
    """(E, Q, way) true cosine similarities of the frame-mean queries to the
    class prototypes (mean over shots and frames)."""
    q = anchor(queries.mean(dim=-2))
    s = anchor(class_sort(support, support_labels, way, shot).mean(dim=(2, -2)))
    qn = q / (safe_norm(q, -1, keepdims=True) + eps)
    sn = s / (safe_norm(s, -1, keepdims=True) + eps)
    return qn @ sn.transpose(-1, -2)

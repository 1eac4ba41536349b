"""Temporal tuple construction (port of ``litemkd_tpu/ops/tuples.py:16-32``).

The TRX head attends over ordered frame tuples: pairs for temp-set 2 give
C(8, 2) = 28 tuples at seq_len 8.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch


def tuple_indices(seq_len: int, set_size: int) -> np.ndarray:
    """(n_tuples, set_size) int32 matrix of ordered frame combinations."""
    return np.asarray(list(combinations(range(seq_len), set_size)), dtype=np.int32)


def gather_tuples(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., T, D) → (..., n_tuples, set_size*D): each tuple's frame features
    concatenated along the channel axis. ``idx`` is a tensor of
    :func:`tuple_indices` on ``x``'s device."""
    g = x[..., idx, :]                          # (..., n_tuples, set_size, D)
    return g.reshape(*g.shape[:-2], g.shape[-2] * g.shape[-1])

"""Sinusoidal positional encoding with the reference's 0.1 scale
(port of ``litemkd_tpu/ops/positional.py:18-42``)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoidal_pe(max_len: int, d_model: int, scale: float = 0.1) -> np.ndarray:
    """Precompute the (max_len, d_model) sinusoidal table, scaled by 0.1."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term) * scale
    pe[:, 1::2] = np.cos(position * div_term) * scale
    return pe


class SinusoidalPE(nn.Module):
    """Adds the fixed sinusoidal table, then dropout (active in train mode).

    The table is the buffer ``pe`` of shape (1, max_len, d_model), the
    reference's name and shape, so reference-layout state dicts load
    strictly."""

    def __init__(self, d_model: int, max_len: int, dropout: float = 0.1,
                 scale: float = 0.1):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe(max_len, d_model, scale))[None])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pe[0, : x.shape[-2]].to(x.dtype)
        return self.dropout(x)

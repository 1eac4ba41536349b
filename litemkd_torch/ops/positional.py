"""Sinusoidal positional encoding with the reference's 0.1 scale
(port of ``litemkd_tpu/ops/positional.py:18-42``)."""
from __future__ import annotations

from typing import Optional

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
    strictly. The dropout mask is drawn from ``generator``, a
    ``torch.Generator`` on x's device that the train step owns and binds
    (:func:`bind_dropout_generator`), as the JAX package draws it from the
    step's ``dropout`` rng; unbound, torch's default generator serves. Kept
    values are scaled by 1/(1-p), as flax's ``nn.Dropout`` does."""

    def __init__(self, d_model: int, max_len: int, dropout: float = 0.1,
                 scale: float = 0.1):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe(max_len, d_model, scale))[None])
        self.p = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pe[0, : x.shape[-2]].to(x.dtype)
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return torch.where(keep.bool(), x / (1.0 - self.p), 0.0)


def bind_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every PE dropout mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, SinusoidalPE):
            m.generator = generator

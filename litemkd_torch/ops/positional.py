"""Positional encodings and dropout (port of
``litemkd_tpu/ops/positional.py:18-60``): the sinusoidal PE with the
reference's 0.1 scale, and the trainable embedding + LayerNorm PE of the MFM
fusion encoders."""
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


class Dropout(nn.Module):
    """Dropout (active in train mode) whose mask is drawn from
    ``generator``, a ``torch.Generator`` on x's device that the train step
    owns and binds (:func:`bind_dropout_generator`), as the JAX package
    draws it from the step's ``dropout`` rng; unbound, torch's default
    generator serves. Kept values are scaled by 1/(1-p), as flax's
    ``nn.Dropout`` does."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return torch.where(keep.bool(), x / (1.0 - self.p), 0.0)


class SinusoidalPE(nn.Module):
    """Adds the fixed sinusoidal table, then :class:`Dropout`.

    The table is the buffer ``pe`` of shape (1, max_len, d_model), the
    reference's name and shape, so reference-layout state dicts load
    strictly."""

    def __init__(self, d_model: int, max_len: int, dropout: float = 0.1,
                 scale: float = 0.1):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe(max_len, d_model, scale))[None])
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(x + self.pe[0, : x.shape[-2]].to(x.dtype))


class TrainablePE(nn.Module):
    """Learned per-frame embedding, then LayerNorm (eps 1e-5), then
    :class:`Dropout` (the MFM fusion blocks). Parameter names are the
    reference's: ``position_embeddings`` (an ``nn.Embedding``, N(0, 1) at
    init) and ``LayerNorm``."""

    def __init__(self, max_len: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_len, d_model)
        self.LayerNorm = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        emb = self.position_embeddings.weight[: x.shape[-2]].to(x.dtype)
        return self.drop(self.LayerNorm(x + emb))


def bind_dropout_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every dropout mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator

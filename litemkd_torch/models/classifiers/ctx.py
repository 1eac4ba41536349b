"""CTX heads (port of ``litemkd_tpu/models/classifiers/ctx.py:30-100``):
temporal self-attention over each video, then the frame-level TCT.

- :class:`TimeTransformer` (the release's compiled ``Time_Transformer``):
  the trainable PE ``positionEncoding``, a 2-layer nhead-8
  ``transformer_encoder`` over the frames, then ``f1`` (d → d) and
  dropout.
- :class:`CTXClassifier` (``CTX``): both sides through the
  TimeTransformer, then the TCT at ``set_size=1`` (single frames, U =
  seq_len tuples), which launches the TCT kernel once a call.
- :class:`CTXVideoAxis` (``CTX_videoaxis``): the teacher-half copy
  (``model.py:2938-3014``), whose encoder has no ``batch_first`` and so
  attends over the videos of one side of an episode at each frame, and
  whose ``f1`` is never applied (the module has none).

Parameter names are the compiled head's (``time_trans.*``,
``transformers.*``), the layout the JAX package's ``export_ctx_classifier``
writes.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.positional import Dropout, TrainablePE
from ...ops.tct import TemporalCrossTransformer
from ..teacher.fusion import Encoder


class TimeTransformer(nn.Module):
    """(..., T, d) → (..., T, d): PE, encoder, and with ``apply_f1`` the
    ``f1`` projection and dropout."""

    def __init__(self, d: int, seq_len: int, depth: int = 2, nhead: int = 8,
                 dropout: float = 0.1, video_axis: bool = False,
                 apply_f1: bool = True):
        super().__init__()
        self.positionEncoding = TrainablePE(seq_len, d, dropout)
        self.transformer_encoder = Encoder(d, nhead, depth, dropout,
                                           video_axis=video_axis)
        if apply_f1:
            self.f1 = nn.Linear(d, d)
            self.drop = Dropout(dropout)
        self.apply_f1 = apply_f1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.transformer_encoder(self.positionEncoding(x))
        return self.drop(self.f1(x)) if self.apply_f1 else x


class CTXClassifier(nn.Module):
    video_axis = False

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, set_size: int = 1, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.time_trans = TimeTransformer(in_dim, seq_len, dropout=dropout,
                                          video_axis=self.video_axis,
                                          apply_f1=not self.video_axis)
        self.transformers = TemporalCrossTransformer(
            way, shot, seq_len, in_dim=in_dim, out_dim=out_dim,
            set_size=set_size, dropout=dropout, compute_dtype=compute_dtype)

    def forward(self, context, context_labels, target):
        return self.transformers(self.time_trans(context), context_labels,
                                 self.time_trans(target))


class CTXVideoAxis(CTXClassifier):
    video_axis = True

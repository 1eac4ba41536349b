"""The skeleton-modality expert encoder (port of
``litemkd_tpu/models/backbones/skeleton.py:29-58``; the reference's
``S3DEncoder``, ``teacher/code/model.py:2788-2818``).

Despite its name it is a temporal transformer over flattened per-frame
joint coordinates: ``t_embedding`` (Linear(J·3 → d), LayerNorm, ReLU,
Linear(d → d)), the 0.1-scaled sinusoidal PE with dropout 0.1, then
``t_tr``, a 3-layer post-LN encoder with nhead 1 and dim_feedforward d.
Parameter names are the reference's, so an S3D artifact's ``encoder.*``
keys map one to one onto ``backbone.*``. The dropout is 0.1 whatever
``trans_dropout`` says, as in the JAX package's registry entries.

``video_axis=True`` (``s3d_videoaxis``, ``skeleton_videoaxis``) reproduces
the released encoder without ``batch_first``: attention runs over the clips
of one backbone call at each frame position, so the student calls it per
episode and side. The PE is per frame either way. The encoder runs in its
parameters' dtype (fp32; float64 in the tests), whatever the trunk dtype,
as the JAX package's runs in the fp32 anchor.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.positional import SinusoidalPE
from ..teacher.fusion import Encoder


class SkeletonEncoder(nn.Module):
    """(B, T, J, C) or (B, T, J·C) skeleton frames → (B, T, out_dim)."""

    def __init__(self, out_dim: int = 2048, joints_dim: int = 17 * 3,
                 seq_len: int = 8, num_head: int = 1, num_layer: int = 3,
                 dropout: float = 0.1, video_axis: bool = False):
        super().__init__()
        d = out_dim
        self.video_axis = video_axis
        self.t_embedding = nn.Sequential(nn.Linear(joints_dim, d),
                                         nn.LayerNorm(d, eps=1e-5), nn.ReLU(),
                                         nn.Linear(d, d))
        self.pe = SinusoidalPE(d, max_len=max(seq_len, 8), dropout=dropout)
        self.t_tr = Encoder(d, num_head, num_layer, dropout, dim_ff=d,
                            video_axis=video_axis)

    def forward(self, skeletons: torch.Tensor) -> torch.Tensor:
        b, t = skeletons.shape[0], skeletons.shape[1]
        x = skeletons.reshape(b, t, -1).to(self.t_embedding[0].weight.dtype)
        x = self.t_embedding(x)
        return self.t_tr(self.pe(x))


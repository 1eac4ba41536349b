"""Supervised per-modality classifier network (port of ``ActionRecognitionNet``,
``litemkd_tpu/models/backbones/classifier_net.py:100-137``).

The reference's ``Action_Recognition_Resnet50`` (``teacher/code/model.py:
3345-3366``), which its pretraining stage trains (``pretrain/pretrain.py``):
a resnet trunk, a global average pool, the mean over frames and a linear
classifier; and the per-frame features that the expert-feature dump writes.
Its state dict is the reference's layout, ``convnet.N.*`` (the trunk under
its ``nn.Sequential`` indices) and ``fc.*``, which the JAX package's
``load_pretrain_init`` and the reference read. The trunk has cuDNN
BatchNorm (no BN kernels), as in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.dtypes import anchor
from .resnet import ResNetTrunk, adaptive_max_pool_2d, run_trunk


class ActionRecognitionNet(nn.Module):
    """uint8 clips (B, T, H, W, 3) → (B, num_classes) logits. The trunk
    runs under autocast in ``compute_dtype``; pooling, the frame mean and
    ``fc`` run in fp32."""

    def __init__(self, num_classes: int, depth: int = 50,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False):
        super().__init__()
        self.convnet = ResNetTrunk(depth, remat=remat)
        self.fc = nn.Linear(self.convnet.width, num_classes)
        self.compute_dtype = compute_dtype

    def features(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, T, D) global-average-pooled trunk features: the
        classification path's pooling (``model.py:3357``)."""
        x, b, t = run_trunk(self.convnet, clips, self.compute_dtype)
        return anchor(x).mean(dim=(1, 2)).reshape(b, t, -1)

    def expert_features(self, clips: torch.Tensor) -> torch.Tensor:
        """(B, T, D) expert-dump features: AdaptiveMaxPool2d (4, 4), then
        the mean over the 16 patches (``model.py:679-703``, what
        ``extract_feature.py`` writes), unlike the GAP of :meth:`features`."""
        x, b, t = run_trunk(self.convnet, clips, self.compute_dtype)
        x = anchor(adaptive_max_pool_2d(x, (4, 4)))
        return x.reshape(b * t, 16, -1).mean(dim=1).reshape(b, t, -1)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return self.fc(self.features(clips).mean(dim=1))

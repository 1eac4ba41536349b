"""ResNet backbones with the Lite-MKD feature head
(port of ``litemkd_tpu/models/backbones/resnet.py:38-61, 100-222``).

The torchvision-resnet-minus-last-two-layers trunk of the reference student
(``resnet18_2fc.py:17-77``): the (7, 7, C) map is adaptive-max-pooled to
(4, 4), the 16 patches are mean-pooled, and fc1/fc2 lift the trunk width to
``out_dim``. Convolutions and BatchNorm are cuDNN through torch, as the JAX
package left them to XLA.

Layouts: clips enter as uint8 NHWC (B, T, H, W, 3), as at the JAX boundary.
The trunk computes in channels-last memory and returns NHWC, so the public
functions keep the JAX package's layout. Parameter names follow the
reference's ``nn.Sequential`` trunk (``resnet.0`` conv1, ``resnet.1`` bn1,
``resnet.4``-``resnet.7`` layer1-layer4), so reference-layout state dicts
load strictly.

Precision: with ``compute_dtype=torch.bfloat16`` the trunk runs under bf16
autocast (convolutions in bf16, BatchNorm statistics in fp32); the 16-patch
mean and fc1/fc2 run in fp32.

BatchNorm is :class:`~litemkd_torch.ops.batch_norm.BatchNorm`: in training
its moments come from the BN-moment CUDA kernels with ``pallas_bn`` (cuDNN
otherwise), and with ``freeze_bn`` it uses the running statistics in
training too (``litemkd_tpu/models/backbones/resnet.py:27-33, 110-136``).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.batch_norm import BatchNorm
from ...ops.dtypes import anchor

Features = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: conv1/bn1/conv2/bn2 and an optional
    ``downsample`` (1×1 conv, BN)."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 bn: Callable[[int], nn.Module] = BatchNorm):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = bn(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = bn(filters)
        self.downsample = None
        if cin != filters or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            bn(filters))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + identity.to(y.dtype))


_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class ResNetTrunk(nn.Sequential):
    """Conv trunk, (N, H, W, 3) → (N, H/32, W/32, 512), NHWC in and out.

    Children are numbered as the reference's ``nn.Sequential(*children)``:
    0 conv1, 1 bn1, 2 relu, 3 maxpool, 4-7 layer1-layer4."""

    def __init__(self, depth: int = 18, pallas_bn: bool = False,
                 freeze_bn: bool = False):
        bn = partial(BatchNorm, eps=1e-5, pallas_bn=pallas_bn,
                     freeze_bn=freeze_bn)
        layers = [nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), bn(64),
                  nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1)]
        cin = 64
        for i, (n_blocks, filters) in enumerate(zip(_STAGES[depth],
                                                    (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock(cin, filters,
                                         2 if (i > 0 and b == 0) else 1, bn))
                cin = filters
            layers.append(nn.Sequential(*blocks))
        super().__init__(*layers)

    def forward(self, x):
        # NHWC → an NCHW view with channels-last strides: cuDNN's native
        # layout for bf16 convolutions, and no copy
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)


def adaptive_max_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveMaxPool2d on NHWC input → (N, oh, ow, C).

    Window i spans [floor(i·L/out), ceil((i+1)·L/out)), overlapping where L
    is not a multiple of out (7 → 4 in the reference)."""
    return F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def flatten_clip_frames(clips: torch.Tensor, compute_dtype: torch.dtype):
    """(B, T, H, W, 3) → ((B·T, H, W, 3) in the compute dtype, B, T). uint8
    pixels are cast to the compute dtype first and then scaled by 1/255."""
    b, t = clips.shape[0], clips.shape[1]
    x = clips.reshape(b * t, *clips.shape[2:]).to(compute_dtype)
    if clips.dtype == torch.uint8:
        x = x / 255.0
    return x, b, t


def litemkd_feature_head(x: torch.Tensor, b: int, t: int, fc1: nn.Linear,
                         fc2: Optional[nn.Linear] = None,
                         pool_hw: Tuple[int, int] = (4, 4)) -> Features:
    """Adaptive max-pool (trunk dtype) → 16-patch mean (fp32) → fc1 [and
    fc2] per frame. Returns (B, T, out_dim), or ``{'f1', 'f2'}`` with fc2."""
    x = adaptive_max_pool_2d(x, pool_hw)
    x = anchor(x.reshape(b * t, -1, x.shape[-1])).mean(dim=1)
    f1 = fc1(x.to(fc1.weight.dtype)).reshape(b, t, -1)
    if fc2 is None:
        return f1
    return {"f1": f1, "f2": fc2(x.to(fc2.weight.dtype)).reshape(b, t, -1)}


class ResNetBackbone(nn.Module):
    """Lite-MKD student backbone: uint8 clips (B, T, H, W, 3) → per-frame
    features, (B, T, out_dim) for ``num_fc=1`` or ``{'f1', 'f2'}`` for
    ``num_fc=2``."""

    def __init__(self, depth: int = 18, num_fc: int = 2, out_dim: int = 2048,
                 pool_hw: Tuple[int, int] = (4, 4),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pallas_bn: bool = False, freeze_bn: bool = False):
        super().__init__()
        if num_fc not in (1, 2):
            raise ValueError(f"num_fc must be 1 or 2, got {num_fc}")
        self.resnet = ResNetTrunk(depth, pallas_bn, freeze_bn)
        self.fc1 = nn.Linear(512, out_dim)
        self.fc2 = nn.Linear(512, out_dim) if num_fc == 2 else None
        self.pool_hw = pool_hw
        self.compute_dtype = compute_dtype

    def forward(self, clips: torch.Tensor) -> Features:
        x, b, t = flatten_clip_frames(clips, self.compute_dtype)
        low = self.compute_dtype in (torch.bfloat16, torch.float16)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low):
            x = self.resnet(x)
        return litemkd_feature_head(x, b, t, self.fc1, self.fc2, self.pool_hw)

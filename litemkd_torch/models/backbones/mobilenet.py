"""MobileNetV3 backbones with the Lite-MKD feature head (port of
``litemkd_tpu/models/backbones/mobilenet.py:25-179``).

The reference wraps torchvision's ``mobilenet_v3_large`` feature extractor
with the resnets' head: 4×4 adaptive max-pool, 16-patch mean, fc1/fc2
(``moblienetv3.py:17-76``); the small width is here too
(``Readme.md:160-161``). Blocks follow the MobileNetV3 paper: inverted
residuals with an optional squeeze-excite, ReLU or hard-swish per stage.

Parameter names are torchvision's under the reference's
``mobile = nn.Sequential(features)`` (``mobile.0.0`` the stem,
``mobile.0.{i+1}.block.{j}`` the blocks, the last entry the 1×1 head; a
lone head is ``fc``), the layout ``litemkd_tpu/tools/torch_export.py:91``
writes, so those files load strictly.

Precision and BatchNorm as in the resnet trunk (cuDNN convolutions under
bf16 autocast, channels-last memory, BatchNorm statistics in fp32), with
the JAX package's ``nn.BatchNorm`` settings: eps 1e-3 and flax momentum
0.99 (torch's 0.01), the running variance updated with the biased batch
variance. The squeeze-excite's two 1×1 products run in the fp32 anchor and
its scale is cast back to the trunk dtype. ``freeze_bn`` gates only
BatchNorm. With ``remat`` each inverted-residual block (not the stem or
the head) runs its forward again in the backward pass; those BatchNorms
update no running statistics there. The trunk takes no BN-moment kernels:
the JAX package uses flax's BatchNorm in it.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.batch_norm import BatchNorm
from ...ops.dtypes import anchor_dtype
from .resnet import Features, _remat_contexts, litemkd_feature_head, run_trunk


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


# (kernel, expansion, out_ch, use_se, use_hs, stride)
_LARGE = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_SMALL = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]
SPECS = {"large": _LARGE, "small": _SMALL}
LAST_CH = {"large": 960, "small": 576}


class _Act(nn.Module):
    def __init__(self, hs: bool):
        super().__init__()
        self.fn = hard_swish if hs else F.relu

    def forward(self, x):
        return self.fn(x)


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
             hs: Optional[bool] = None, bn=BatchNorm) -> nn.Sequential:
    """torchvision's ``Conv2dNormActivation``: ``0`` the bias-free conv,
    ``1`` the BatchNorm, then hard-swish (``hs`` True), ReLU (False) or
    nothing (None); the activation has no parameters."""
    layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                        bias=False), bn(cout)]
    if hs is not None:
        layers.append(_Act(hs))
    return nn.Sequential(*layers)


class SqueezeExcite(nn.Module):
    """torchvision's ``SqueezeExcitation``: spatial mean, ``fc1`` (1×1
    conv), ReLU, ``fc2``, hard-sigmoid, channel scale. The products run in
    the fp32 anchor outside autocast."""

    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        adt = anchor_dtype(x.dtype)
        with torch.autocast(x.device.type, enabled=False):
            s = x.mean(dim=(2, 3)).to(adt)
            s = F.relu(F.linear(s, self.fc1.weight.flatten(1).to(adt),
                                self.fc1.bias.to(adt)))
            s = hard_sigmoid(F.linear(s, self.fc2.weight.flatten(1).to(adt),
                                      self.fc2.bias.to(adt)))
        return x * s[:, :, None, None].to(x.dtype)


class InvertedResidual(nn.Module):
    """torchvision's ``InvertedResidual``: under ``block``, the 1×1
    expansion (absent where it would keep the width), the depthwise conv
    (``groups=expand``), the squeeze-excite, the 1×1 projection; the
    residual where the stride is 1 and the width is kept."""

    def __init__(self, cin: int, kernel: int, expand: int, out_ch: int,
                 use_se: bool, use_hs: bool, stride: int, bn=BatchNorm):
        super().__init__()
        layers = []
        if expand != cin:
            layers.append(_conv_bn(cin, expand, 1, hs=use_hs, bn=bn))
        layers.append(_conv_bn(expand, expand, kernel, stride, groups=expand,
                               hs=use_hs, bn=bn))
        if use_se:
            layers.append(SqueezeExcite(expand, _make_divisible(expand / 4)))
        layers.append(_conv_bn(expand, out_ch, 1, bn=bn))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == out_ch

    def forward(self, x):
        y = self.block(x)
        return y + x.to(y.dtype) if self.residual else y


class MobileNetV3Trunk(nn.Sequential):
    """torchvision's ``features``: (N, H, W, 3) → (N, H/32, W/32,
    ``LAST_CH[variant]``), NHWC in and out."""

    def __init__(self, variant: str = "large", freeze_bn: bool = False,
                 remat: bool = False):
        if variant not in SPECS:
            raise ValueError(f"mobilenet variant must be large or small, got "
                             f"{variant!r}")
        bn = partial(BatchNorm, eps=1e-3, momentum=0.01, freeze_bn=freeze_bn)
        layers = [_conv_bn(3, 16, 3, 2, hs=True, bn=bn)]
        cin = 16
        for k, e, o, se, hs, s in SPECS[variant]:
            layers.append(InvertedResidual(cin, k, e, o, se, hs, s, bn))
            cin = o
        layers.append(_conv_bn(cin, LAST_CH[variant], 1, hs=True, bn=bn))
        super().__init__(*layers)
        self.remat = remat

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self:
            if remat and isinstance(layer, InvertedResidual):
                y = checkpoint(layer, y, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=partial(_remat_contexts, layer))
            else:
                y = layer(y)
        return y.permute(0, 2, 3, 1)


class MobileNetV3Backbone(nn.Module):
    """Lite-MKD MobileNetV3 student backbone: uint8 clips (B, T, H, W, 3)
    → (B, T, out_dim) features with one head (``fc``) or ``{'f1', 'f2'}``
    with two (``fc1``, ``fc2``)."""

    def __init__(self, variant: str = "large", num_fc: int = 2,
                 out_dim: int = 2048, pool_hw: Tuple[int, int] = (4, 4),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 freeze_bn: bool = False, remat: bool = False):
        super().__init__()
        if num_fc not in (1, 2):
            raise ValueError(f"num_fc must be 1 or 2, got {num_fc}")
        self.mobile = nn.Sequential(MobileNetV3Trunk(variant, freeze_bn, remat))
        self.fc_names = ("fc",) if num_fc == 1 else ("fc1", "fc2")
        for name in self.fc_names:
            setattr(self, name, nn.Linear(LAST_CH[variant], out_dim))
        self.pool_hw = pool_hw
        self.compute_dtype = compute_dtype

    def forward(self, clips: torch.Tensor) -> Features:
        x, b, t = run_trunk(self.mobile[0], clips, self.compute_dtype)
        return litemkd_feature_head(
            x, b, t, tuple(getattr(self, n) for n in self.fc_names), self.pool_hw)

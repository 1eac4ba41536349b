"""ResNet backbones with the Lite-MKD feature head
(port of ``litemkd_tpu/models/backbones/resnet.py:38-222``).

The torchvision-resnet-minus-last-two-layers trunk of the reference student
(``resnet18_2fc.py:17-77``): the (7, 7, C) map is adaptive-max-pooled to
(4, 4), the 16 patches are mean-pooled, and fc1/fc2 lift the trunk width to
``out_dim``. Depth 18 and 34 stack torchvision's BasicBlock, depth 50 its
Bottleneck (stride on the 3×3 conv, trunk width 2048). Convolutions and
BatchNorm are cuDNN through torch, as the JAX package left them to XLA.

Layouts: clips enter as uint8 NHWC (B, T, H, W, 3), as at the JAX boundary.
The trunk computes in channels-last memory and returns NHWC, so the public
functions keep the JAX package's layout. Parameter names follow the
reference's ``nn.Sequential`` trunk (``resnet.0`` conv1, ``resnet.1`` bn1,
``resnet.4``-``resnet.7`` layer1-layer4, ``resnet.4.0.downsample.0/1``), so
reference-layout state dicts load strictly.

Precision: with ``compute_dtype=torch.bfloat16`` the trunk runs under bf16
autocast (convolutions in bf16, BatchNorm statistics in fp32); the 16-patch
mean and fc1/fc2 run in fp32.

BatchNorm is :class:`~litemkd_torch.ops.batch_norm.BatchNorm`: in training
its moments come from the BN-moment CUDA kernels with ``pallas_bn`` (cuDNN
otherwise), and with ``freeze_bn`` it uses the running statistics in
training too (``litemkd_tpu/models/backbones/resnet.py:27-33, 110-136``).
With ``remat`` each residual block (not the stem) keeps only its input for
the backward pass and runs its forward again there
(``torch.utils.checkpoint``, as ``nn.remat`` wraps the JAX package's
blocks); the BatchNorms of that second run update no running statistics.
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, Dict, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.batch_norm import BatchNorm
from ...ops.dtypes import anchor

Features = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """torchvision's BasicBlock: conv1/bn1/conv2/bn2 and an optional
    ``downsample`` (1×1 conv, BN)."""

    expansion = 1

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


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: 1×1 conv1, 3×3 conv2 (carrying the
    stride), 1×1 conv3 to 4× ``filters``, bn1-bn3, and an optional
    ``downsample`` (1×1 conv, BN)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 bn: Callable[[int], nn.Module] = BatchNorm):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = bn(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = bn(filters)
        self.conv3 = _conv(filters, out, 1)
        self.bn3 = bn(out)
        self.downsample = None
        if cin != out or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), bn(out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity.to(y.dtype))


# depth → (block, blocks per stage)
_STAGES = {18: (BasicBlock, (2, 2, 2, 2)), 34: (BasicBlock, (3, 4, 6, 3)),
           50: (Bottleneck, (3, 4, 6, 3))}


def _remat_contexts(block: nn.Module):
    """checkpoint's ``context_fn`` for ``block``: nothing around the first
    forward, and its BatchNorms marked ``recomputing`` around the second."""
    bns = [m for m in block.modules() if isinstance(m, BatchNorm)]

    @contextlib.contextmanager
    def recompute():
        for m in bns:
            m.recomputing = True
        try:
            yield
        finally:
            for m in bns:
                m.recomputing = False

    return contextlib.nullcontext(), recompute()


class ResNetTrunk(nn.Sequential):
    """Conv trunk, (N, H, W, 3) → (N, H/32, W/32, ``width``), NHWC in and
    out; ``width`` is 512 at depth 18 and 34 and 2048 at depth 50.

    Children are numbered as the reference's ``nn.Sequential(*children)``:
    0 conv1, 1 bn1, 2 relu, 3 maxpool, 4-7 layer1-layer4."""

    def __init__(self, depth: int = 18, pallas_bn: bool = False,
                 freeze_bn: bool = False, remat: bool = False):
        if depth not in _STAGES:
            raise ValueError(f"resnet depth {depth} is not ported (18, 34, 50)")
        bn = partial(BatchNorm, eps=1e-5, pallas_bn=pallas_bn,
                     freeze_bn=freeze_bn)
        block, stages = _STAGES[depth]
        layers = [nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), bn(64),
                  nn.ReLU(), nn.MaxPool2d(3, stride=2, padding=1)]
        cin = 64
        for i, (n_blocks, filters) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(cin, filters, 2 if (i > 0 and b == 0) else 1,
                                    bn))
                cin = filters * block.expansion
            layers.append(nn.Sequential(*blocks))
        super().__init__(*layers)
        self.width = cin
        self.remat = remat

    def forward(self, x):
        # NHWC → an NCHW view with channels-last strides: cuDNN's native
        # layout for bf16 convolutions, and no copy
        y = x.permute(0, 3, 1, 2)
        remat = self.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self):
            if remat and i >= 4:
                for block in layer:
                    y = checkpoint(block, y, use_reentrant=False,
                                   preserve_rng_state=False,
                                   context_fn=partial(_remat_contexts, block))
            else:
                y = layer(y)
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


def run_trunk(trunk: ResNetTrunk, clips: torch.Tensor,
              compute_dtype: torch.dtype):
    """Clips (B, T, H, W, 3) through ``trunk`` as one (B·T)-image batch,
    under autocast in ``compute_dtype`` when it is bf16 or fp16 →
    ((B·T, h, w, C) map, B, T)."""
    x, b, t = flatten_clip_frames(clips, compute_dtype)
    low = compute_dtype in (torch.bfloat16, torch.float16)
    with torch.autocast(x.device.type, dtype=compute_dtype, enabled=low):
        return trunk(x), b, t


def litemkd_feature_head(x: torch.Tensor, b: int, t: int,
                         fcs: Tuple[nn.Linear, ...] = (),
                         pool_hw: Tuple[int, int] = (4, 4),
                         pool: str = "adaptive_max") -> Features:
    """Adaptive max-pool (trunk dtype) → 16-patch mean (fp32), or with
    ``pool="gap"`` the global mean (fp32), then the heads ``fcs`` per
    frame. Returns (B, T, trunk width) with no head, (B, T, out_dim) with
    one, or ``{'f1', 'f2'}`` with two."""
    if pool == "gap":
        x = anchor(x).mean(dim=(1, 2))
    else:
        x = adaptive_max_pool_2d(x, pool_hw)
        x = anchor(x.reshape(b * t, -1, x.shape[-1])).mean(dim=1)
    out = [fc(x.to(fc.weight.dtype)).reshape(b, t, -1) for fc in fcs]
    if not out:
        return x.reshape(b, t, -1)
    if len(out) == 1:
        return out[0]
    return {"f1": out[0], "f2": out[1]}


class ResNetBackbone(nn.Module):
    """Lite-MKD student backbone: uint8 clips (B, T, H, W, 3) → per-frame
    features: (B, T, trunk width) for ``num_fc=0``, (B, T, out_dim) for
    ``num_fc=1`` or ``{'f1', 'f2'}`` for ``num_fc=2``. The heads are named
    as in the reference: ``fc1``/``fc2``, and a lone head ``fc_name``
    (``res18_2048`` in ``resnet18_student.py``, ``fc`` in
    ``meta_baseline.py``). ``pool="gap"`` takes the global mean of the map
    instead of the 4×4 max-pool (the TRM trunks)."""

    def __init__(self, depth: int = 18, num_fc: int = 2, out_dim: int = 2048,
                 pool_hw: Tuple[int, int] = (4, 4), pool: str = "adaptive_max",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 pallas_bn: bool = False, freeze_bn: bool = False,
                 remat: bool = False, fc_name: str = "fc1"):
        super().__init__()
        if num_fc not in (0, 1, 2):
            raise ValueError(f"num_fc must be 0, 1 or 2, got {num_fc}")
        if pool not in ("adaptive_max", "gap"):
            raise ValueError(f"pool must be adaptive_max or gap, got {pool!r}")
        self.resnet = ResNetTrunk(depth, pallas_bn, freeze_bn, remat)
        self.fc_names = ((), (fc_name,), ("fc1", "fc2"))[num_fc]
        for name in self.fc_names:
            setattr(self, name, nn.Linear(self.resnet.width, out_dim))
        self.pool_hw = pool_hw
        self.pool = pool
        self.compute_dtype = compute_dtype

    def forward(self, clips: torch.Tensor) -> Features:
        x, b, t = run_trunk(self.resnet, clips, self.compute_dtype)
        return litemkd_feature_head(
            x, b, t, tuple(getattr(self, n) for n in self.fc_names),
            self.pool_hw, self.pool)


class FeatureBackbone(nn.Module):
    """The identity backbone for precomputed features
    (``litemkd_tpu/models/backbones/resnet.py:225-235``): the teacher's
    episodes, with a CNN backbone's calling convention."""

    def forward(self, feats: Features) -> Features:
        return feats

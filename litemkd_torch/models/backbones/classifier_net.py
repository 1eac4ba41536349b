"""Supervised per-modality classifier networks (port of
``litemkd_tpu/models/backbones/classifier_net.py:18-137``): the resnet
``ActionRecognitionNet`` and the DeiT-small ``ViTClassifier``.

``ActionRecognitionNet`` is the reference's ``Action_Recognition_Resnet50``
(``teacher/code/model.py:3345-3366``), which its pretraining stage trains
(``pretrain/pretrain.py``): a resnet trunk, a global average pool, the mean
over frames and a linear classifier; and the per-frame features that the
expert-feature dump writes. Its state dict is the reference's layout,
``convnet.N.*`` (the trunk under its ``nn.Sequential`` indices) and
``fc.*``, which the JAX package's ``load_pretrain_init`` and the reference
read. The trunk has cuDNN BatchNorm (no BN kernels), as in the JAX package.

``ViTClassifier`` is the reference's ``model_distillation``
(``model.py:2142-2157``, timm's ``deit_small_distilled_patch16_224`` and a
linear head) as the JAX package rebuilds it: its state dict is timm's
names under ``convnet.`` and ``fc.*``, the layout of a saved
``model_distillation``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
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


class PatchEmbed(nn.Module):
    """timm's patch embedding: one ``proj`` convolution of stride
    ``patch``."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Attention(nn.Module):
    """Multi-head self-attention with timm's fused ``qkv`` (rows q; k; v,
    each head-major) and ``proj``; q·kᵀ is scaled by 1/√head_dim, as in
    flax's attention."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    """fc1, GELU in flax's tanh form, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-LN encoder block; LayerNorm epsilon 1e-6, flax's."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x)).to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class DeiTTrunk(nn.Module):
    """The DeiT trunk under timm's names: (N, H, W, 3) images → (N, dim),
    the mean of the final-normed cls and distillation tokens."""

    def __init__(self, img_size: int = 224, patch: int = 16, dim: int = 384,
                 depth: int = 12, heads: int = 6, mlp_ratio: int = 4):
        super().__init__()
        self.patch_embed = PatchEmbed(patch, dim)
        n_tok = (img_size // patch) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok + 2, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def reset_tokens_(self, generator: torch.Generator) -> None:
        """The three token parameters from N(0, 0.02²), as the JAX package
        draws them."""
        with torch.no_grad():
            for p in (self.cls_token, self.dist_token, self.pos_embed):
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                 # (N, tokens, dim)
        b = x.shape[0]
        x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype),
                       self.dist_token.expand(b, -1, -1).to(x.dtype), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return (x[:, 0] + x[:, 1]) / 2.0


class ViTClassifier(nn.Module):
    """uint8 (B, H, W, 3) images → (B, num_classes) logits; a (B, T, H, W, 3)
    clip is scored per frame and its logits averaged over T. Pixels are
    divided by 255 only. ``img_size`` is fixed at construction (the
    positional table's size), and another input size raises. The trunk runs
    under autocast in ``compute_dtype``; the head ``fc``, one Linear over
    the mean of the two tokens, runs in fp32."""

    def __init__(self, num_classes: int, img_size: int = 224, patch: int = 16,
                 dim: int = 384, depth: int = 12, heads: int = 6,
                 mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.convnet = DeiTTrunk(img_size, patch, dim, depth, heads, mlp_ratio)
        self.fc = nn.Linear(dim, num_classes)
        self.img_size = img_size
        self.compute_dtype = compute_dtype

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        frames = None
        if images.dim() == 5:
            frames = images.shape[1]
            images = images.reshape(-1, *images.shape[2:])
        if images.shape[1] != self.img_size or images.shape[2] != self.img_size:
            raise ValueError(f"ViTClassifier(img_size={self.img_size}) got "
                             f"{images.shape[1]}x{images.shape[2]} input: "
                             "pos_embed is sized at construction")
        x = images.to(self.compute_dtype)
        if images.dtype == torch.uint8:
            x = x / 255.0
        low = self.compute_dtype in (torch.bfloat16, torch.float16)
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low):
            feat = self.convnet(x)
        logits = self.fc(anchor(feat))
        if frames is not None:
            logits = logits.reshape(-1, frames, logits.shape[-1]).mean(dim=1)
        return logits

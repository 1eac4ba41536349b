"""STRM backbones (port of ``litemkd_tpu/models/backbones/strm.py:26-69``;
the reference's ``strm18_student.py:207-294``, ``strmbackbone.py:207-309``
and CNN_STRM, ``teacher/code/model.py:3123-3344``).

uint8 clips → resnet trunk (cuDNN BatchNorm, as the JAX package gives this
trunk no BN kernels) → 4×4 adaptive max-pool → :class:`SelfAttnBot` over
the 16 patches (h-major, the NHWC order) at the trunk width → patch mean →
``lift`` to ``out_dim``. That is the 'distance' stream; :class:`MLPMixEnrich`
over the frames then gives 'trx' (one stream) or, through ``fc1``/``fc2``,
'trx1'/'trx2'. The trunk runs under autocast in ``compute_dtype``; from the
pool on everything runs in fp32.

Keys follow the reference's CNN_STRM: ``resnet.<seq>.…``, ``attn_pat.*``
(``value_conv`` among them), ``fr_enrich.*``, plus ``lift`` and
``fc1``/``fc2``.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops.dtypes import anchor
from ...ops.strm import MLPMixEnrich, SelfAttnBot
from .resnet import ResNetTrunk, adaptive_max_pool_2d, run_trunk


class STRMBackbone(nn.Module):
    """Clips (B, T, H, W, 3) → {'distance', 'trx1', 'trx2'} (``num_fc=2``)
    or {'distance', 'trx'} (``num_fc=1``), each (B, T, out_dim).
    ``dropout`` is the enrichment blocks' PE dropout
    (``cfg.model.trans_dropout``, as the JAX package threads it)."""

    def __init__(self, depth: int = 18, num_fc: int = 2, out_dim: int = 2048,
                 seq_len: int = 8, compute_dtype: torch.dtype = torch.bfloat16,
                 remat: bool = False, freeze_bn: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        if num_fc not in (1, 2):
            raise ValueError(f"num_fc must be 1 or 2, got {num_fc}")
        self.resnet = ResNetTrunk(depth, freeze_bn=freeze_bn, remat=remat)
        width = self.resnet.width
        self.attn_pat = SelfAttnBot(width, 16, dropout=dropout)
        self.lift = nn.Linear(width, out_dim)
        self.fr_enrich = MLPMixEnrich(out_dim, seq_len, dropout=dropout)
        self.num_fc = num_fc
        if num_fc == 2:
            self.fc1 = nn.Linear(out_dim, out_dim)
            self.fc2 = nn.Linear(out_dim, out_dim)
        self.compute_dtype = compute_dtype

    def forward(self, clips: torch.Tensor) -> Dict[str, torch.Tensor]:
        x, b, t = run_trunk(self.resnet, clips, self.compute_dtype)
        x = anchor(adaptive_max_pool_2d(x, (4, 4)))
        x = self.attn_pat(x.reshape(b * t, 16, x.shape[-1])).mean(dim=1)
        pat = self.lift(x).reshape(b, t, -1)                 # pre-enrichment
        fr = self.fr_enrich(pat)
        if self.num_fc == 2:
            return {"distance": pat, "trx1": self.fc1(fr), "trx2": self.fc2(fr)}
        return {"distance": pat, "trx": fr}

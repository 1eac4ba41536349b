"""STRM enrichment blocks and the patch-level distance head (port of
``litemkd_tpu/ops/strm.py:30-139``; the reference's
``strm18_student.py:42-205`` and ``strmclassifiers_res18.py:162-246``).

- :class:`TokenMLP` (also the 2-layer bottleneck, :data:`BottleneckMLP2`) and
  :class:`BottleneckMLP3Res`: small MLPs over the token or channel axis;
- :class:`SelfAttnBot`: patch self-attention (no 1/√d scale) behind a
  learned gate ``gamma`` that starts at 0, then a residual 3-layer
  bottleneck MLP;
- :class:`MLPMixEnrich`: token mixing over frames, then a channel
  bottleneck, each residual;
- :class:`STRMDistance`: for each query tuple the least euclidean distance
  over a class's (shot × tuple) pool of ReLU'd ``clsW`` projections of
  frame-pair tuples, meaned over query tuples and negated.

Parameter names are the reference's (``query_proj``, ``key_proj``,
``value_conv``, ``gamma``, ``Bot_MLP``, ``Tok_MLP``, ``clsW``), which the
JAX package's ``load_cnn_strm_checkpoint`` reads. Every block's dropout
draws from the generator that :func:`bind_dropout_generator` binds.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dtypes import anchor
from .positional import Dropout, SinusoidalPE
from .tct import class_sort
from .tuples import gather_tuples, tuple_indices


class TokenMLP(nn.Module):
    """Two Linear layers of width ``dim`` with a ReLU between (the
    reference's ``Token_Perceptron``, and its byte-identical
    ``Bottleneck_Perceptron_2_layer``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.inp_fc = nn.Linear(dim, dim)
        self.out_fc = nn.Linear(dim, dim)

    def forward(self, x):
        return self.out_fc(F.relu(self.inp_fc(x)))


# the reference's Bottleneck_Perceptron_2_layer (the fusion teachers' MLP
# post-processors) is byte-identical to Token_Perceptron
BottleneckMLP2 = TokenMLP


class BottleneckMLP3Res(nn.Module):
    """dim → dim/2 → dim/2 → dim with ReLUs, plus the input."""

    def __init__(self, dim: int):
        super().__init__()
        h = dim // 2
        self.inp_fc = nn.Linear(dim, h)
        self.hid_fc = nn.Linear(h, h)
        self.out_fc = nn.Linear(h, dim)

    def forward(self, x):
        y = F.relu(self.hid_fc(F.relu(self.inp_fc(x))))
        return self.out_fc(y) + x


class SelfAttnBot(nn.Module):
    """Patch self-attention enrichment (``Self_Attn_Bot``) over (N, tokens,
    dim)."""

    def __init__(self, dim: int, n_tokens: int, dropout: float = 0.1):
        super().__init__()
        self.pe = SinusoidalPE(dim, max_len=int(n_tokens * 1.5), dropout=dropout)
        self.query_proj = nn.Linear(dim, dim)
        self.key_proj = nn.Linear(dim, dim)
        self.value_conv = nn.Linear(dim, dim)      # the released name
        self.gamma = nn.Parameter(torch.zeros(1))
        self.Bot_MLP = BottleneckMLP3Res(dim)

    def forward(self, x):
        x = self.pe(x)
        attn = torch.softmax(self.query_proj(x) @ self.key_proj(x).transpose(1, 2),
                             dim=-1)
        out = self.gamma * (attn @ self.value_conv(x)) + x
        return self.Bot_MLP(out)


class MLPMixEnrich(nn.Module):
    """Frame-level token mixing and channel bottleneck (``MLP_Mix_Enrich``)
    over (B, seq_len, dim)."""

    def __init__(self, dim: int, seq_len: int, dropout: float = 0.1):
        super().__init__()
        self.pe = SinusoidalPE(dim, max_len=int(seq_len * 1.5), dropout=dropout)
        self.Tok_MLP = TokenMLP(seq_len)
        self.Bot_MLP = TokenMLP(dim)

    def forward(self, x):
        x = self.pe(x)
        y = self.Tok_MLP(x.transpose(-1, -2)).transpose(-1, -2) + x
        return self.Bot_MLP(y) + y


class STRMDistance(nn.Module):
    """Patch-stream query-class distance logits (``DistanceLoss``), over a
    batch of episodes: support (E, way·shot, T, D), labels (E, way·shot),
    queries (E, Q, T, D) → (E, Q, way). Dropout draws one mask for the
    support and another for the queries."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 set_size: int = 2, dropout: float = 0.1):
        super().__init__()
        self.way, self.shot = way, shot
        self.drop = Dropout(dropout)
        self.clsW = nn.Linear(set_size * in_dim, in_dim // 2)
        self.register_buffer(
            "tuples", torch.from_numpy(tuple_indices(seq_len, set_size)).long(),
            persistent=False)

    def forward(self, support, support_labels, queries):
        s_e = anchor(F.relu(self.clsW(gather_tuples(self.drop(support),
                                                    self.tuples))))
        q_e = anchor(F.relu(self.clsW(gather_tuples(self.drop(queries),
                                                    self.tuples))))
        class_e = class_sort(s_e, support_labels, self.way, self.shot)
        e, u = class_e.shape[0], q_e.shape[2]
        class_e = class_e.reshape(e, self.way, self.shot * u, -1)  # (E,W,SU,h)
        qq = (q_e * q_e).sum(-1)[..., None, None]                  # (E,Q,U,1,1)
        ss = (class_e * class_e).sum(-1)[:, None, None]            # (E,1,1,W,SU)
        cross = torch.einsum("equd,ewkd->equwk", q_e, class_e)
        dist = torch.sqrt(torch.clamp(qq + ss - 2.0 * cross, min=1e-12))
        return -dist.amin(dim=-1).mean(dim=2)                      # (E, Q, W)

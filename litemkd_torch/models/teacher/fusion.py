"""The MFM hierarchical multi-modal fusion teacher (port of
``litemkd_tpu/models/teacher/fusion.py:67-413``; the reference's
``ThreeTRXShiftLoopTime``).

- :class:`EncoderLayer` / :class:`Encoder`: the post-LN
  ``nn.TransformerEncoderLayer`` of the reference (ReLU FFN 2048 wide,
  dropout 0.1) written out as projections and a softmax, so every dropout
  draws from the train step's generator and eval mode computes the same
  arithmetic as training mode.
- :class:`MultiStreamFusion`: per-stream trainable PEs, concatenation along
  channels, the encoder, and the ``f1`` projection back to d;
  :class:`TwoStreamFusion` and :class:`ThreeStreamFusion` are its 2- and
  3-stream cases.
- :class:`TrxBranch`: the TCT stack over the fused features.
- :class:`MFMTeacher`: fused = three_fusion(m1, m2, m3) + fusion(m1, m2
  rolled left) + fusion(m1, m3'), then the TrxBranch. m3' is m3 itself in
  ``forward`` (the released reference's no-op "shift") and m3 rolled left in
  ``extract`` (the released ``extract_feature``); ``third_shift="right"``
  rolls it right in both.

A batch of E episodes of N videos, (E, N, T, D) per modality, fuses as
E·N videos: attention runs over the T frames of each video.

Parameter names are the reference's, so a ``ThreeTRXShiftLoopTime`` state
dict (``three_fusion.*``, ``fusion.*``, ``bracnch.transformers.{i}.*``)
loads strictly.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.positional import Dropout, TrainablePE
from ...ops.tct import MultiSetTCT


class SelfAttention(nn.Module):
    """Multi-head self-attention with the parameters of torch's
    ``nn.MultiheadAttention``: the stacked (3d, d) ``in_proj_weight`` (q; k;
    v) with ``in_proj_bias``, and ``out_proj``. Dropout acts on the
    attention probabilities, as in torch."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"nhead {nhead}")
        self.nhead = nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.drop_probs = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        h = self.nhead
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(n, t, 3, h, d // h).unbind(2)
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d // h)
        attn = self.drop_probs(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, t, d)
        return self.out_proj(ctx)


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (torch ``TransformerEncoderLayer``
    defaults: ReLU FFN, dim_feedforward 2048, dropout 0.1), over (N, T, D)
    with attention over T."""

    def __init__(self, d_model: int, nhead: int, dim_ff: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = SelfAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x)))
        y = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(y))


class Encoder(nn.Module):
    """``depth`` encoder layers under the reference's ``layers`` list."""

    def __init__(self, d_model: int, nhead: int, depth: int,
                 dropout: float = 0.1, dim_ff: int = 2048):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead, dim_ff, dropout)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class MultiStreamFusion(nn.Module):
    """N-modality concatenate-encode-project fusion: stream i through
    ``positionEncoding{i+1}``, the streams concatenated along channels, the
    ``transformer_encoder`` (N·d wide; 3 heads for 3 streams, else 2, as
    the reference's Three/Four/FiveTransfor* classes), ``f1`` back to d,
    then dropout. Streams are (..., T, d); leading axes fold into one."""

    def __init__(self, n_streams: int, seq_len: int, d: int = 2048,
                 depth: int = 2, dropout: float = 0.1):
        super().__init__()
        self.n_streams = n_streams
        for i in range(n_streams):
            setattr(self, f"positionEncoding{i + 1}",
                    TrainablePE(seq_len, d, dropout))
        self.transformer_encoder = Encoder(
            n_streams * d, 3 if n_streams == 3 else 2, depth, dropout)
        self.f1 = nn.Linear(n_streams * d, d)
        self.drop_out = Dropout(dropout)

    def forward(self, *streams: torch.Tensor) -> torch.Tensor:
        if len(streams) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got "
                             f"{len(streams)}")
        lead, (t, d) = streams[0].shape[:-2], streams[0].shape[-2:]
        x = torch.cat([getattr(self, f"positionEncoding{i + 1}")(
            m.reshape(-1, t, d)) for i, m in enumerate(streams)], dim=-1)
        x = self.drop_out(self.f1(self.transformer_encoder(x)))
        return x.reshape(*lead, t, d)


class TwoStreamFusion(MultiStreamFusion):
    """``TwoTransforFusion``: two streams, 2 heads."""

    def __init__(self, seq_len: int, d: int = 2048, depth: int = 2,
                 dropout: float = 0.1):
        super().__init__(2, seq_len, d, depth, dropout)


class ThreeStreamFusion(MultiStreamFusion):
    """``ThreeTransforTemproal``: three streams, 3 heads."""

    def __init__(self, seq_len: int, d: int = 2048, depth: int = 2,
                 dropout: float = 0.1):
        super().__init__(3, seq_len, d, depth, dropout)


# the reference's name (model.py:1094-1128) for the TCT stack over fused
# features; its sets sit at ``transformers.{i}``
TrxBranch = MultiSetTCT


def _roll_left(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([x[..., s:, :], x[..., :s, :]], dim=-2)


def _roll_right(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([x[..., -s:, :], x[..., :-s, :]], dim=-2)


class MFMTeacher(nn.Module):
    """Hierarchical multi-modal fusion (``ThreeTRXShiftLoopTime``) over a
    batch of episodes.

    ``forward(context_feats, context_labels, target_feats)``: the feats are
    dicts keyed by modality name, each (E, N, T, D); labels (E, way·shot)
    → ``{'logits': (E, Q, way)}``. ``extract(feats)``: (..., T, D) per
    modality → fused (..., T, D)."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, temp_set=(2,), depth: int = 2,
                 shirt_num: int = 1,
                 modalities: Sequence[str] = ("rgb", "depth", "flow"),
                 dropout: float = 0.1, third_shift: str = "reference",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if third_shift not in ("reference", "right"):
            raise ValueError(f"third_shift must be 'reference' or 'right', "
                             f"got {third_shift!r}")
        self.modalities = tuple(modalities)
        self.shirt_num = shirt_num
        self.third_shift = third_shift
        # ThreeStreamFusion for 3 modalities; the Four/FiveShiftFusion
        # generalisation (model.py:1712-1894) for 2, 4 or 5
        self.three_fusion = MultiStreamFusion(len(self.modalities), seq_len,
                                              in_dim, depth, dropout)
        self.fusion = TwoStreamFusion(seq_len, in_dim, depth, dropout)
        self.bracnch = TrxBranch(way, shot, seq_len, in_dim, out_dim,
                                 temp_set, dropout, compute_dtype)

    def fuse(self, feats: Dict[str, torch.Tensor], *,
             dump: bool = False) -> torch.Tensor:
        """three_fusion over all modalities plus the pairwise fusions of m1
        with m2 rolled left by ``shirt_num`` and with each later modality:
        unshifted ("reference"), rolled left when ``dump`` (the released
        extraction), or rolled right (``third_shift="right"``)."""
        streams = [feats[m] for m in self.modalities]
        fused = self.three_fusion(*streams)
        fused = fused + self.fusion(streams[0],
                                    _roll_left(streams[1], self.shirt_num))
        for extra in streams[2:]:
            if self.third_shift == "right":
                shifted = _roll_right(extra, self.shirt_num)
            elif dump:
                shifted = _roll_left(extra, self.shirt_num)
            else:
                shifted = extra
            fused = fused + self.fusion(streams[0], shifted)
        return fused

    def forward(self, context_feats, context_labels, target_feats):
        logits = self.bracnch(self.fuse(context_feats), context_labels,
                              self.fuse(target_feats))
        return {"logits": logits}

    def extract(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-video fused features, as the released ``extract_feature``
        dumps them (model.py:1648-1663): later modalities rolled left in
        "reference" mode, unlike ``forward``. Call it in eval mode."""
        return self.fuse(feats, dump=True)


def init_mfm_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight of an MFM teacher from ``generator`` with
    torch's initialisers: linear weights and biases U(-1/√fan_in,
    1/√fan_in); the attention's stacked ``in_proj_weight`` xavier-uniform
    over (3d, d) and zero biases on ``in_proj`` and ``out_proj``, as
    ``nn.MultiheadAttention`` does; embeddings N(0, 1); LayerNorms at
    identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        for m in model.modules():
            if isinstance(m, SelfAttention):
                three_d, d = m.in_proj_weight.shape
                bound = math.sqrt(6.0 / (three_d + d))
                m.in_proj_weight.uniform_(-bound, bound, generator=generator)
                m.in_proj_bias.zero_()
                m.out_proj.bias.zero_()
    return model

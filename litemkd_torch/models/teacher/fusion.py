"""The fusion teachers (port of ``litemkd_tpu/models/teacher/fusion.py``;
the reference's ``teacher/code/model.py`` fusion classes).

- :class:`EncoderLayer` / :class:`Encoder`: the post-LN
  ``nn.TransformerEncoderLayer`` of the reference (ReLU FFN 2048 wide,
  dropout 0.1) written out as projections and a softmax, so every dropout
  draws from the train step's generator and eval mode computes the same
  arithmetic as training mode.
- :class:`MultiStreamFusion`: per-stream trainable PEs, concatenation along
  channels, the encoder, and the ``f1`` projection back to d;
  :class:`TwoStreamFusion` and :class:`ThreeStreamFusion` are its 2- and
  3-stream cases.
- :class:`CrossAttentionFusion` (BERT cross attention),
  :class:`SelfEncoderBranch` and :class:`BatchStatFusion`: the other branch
  kinds of the composer (``composer.py``).
- :class:`TrxBranch`: the TCT stack over the fused features.
- :class:`MFMTeacher`: fused = three_fusion(m1, m2, m3) + fusion(m1, m2
  rolled left) + fusion(m1, m3'), then the TrxBranch. m3' is m3 itself in
  ``forward`` (the released reference's no-op "shift") and m3 rolled left in
  ``extract`` (the released ``extract_feature``); ``third_shift="right"``
  rolls it right in both.
- :class:`DGAFusionTeacher` (ThreeFusionDGA/DGA2),
  :class:`TwoRoadFusionTeacher` (ThreeFusionTwoRoad) and
  :class:`ScoreFusion` (TSF): the bespoke teachers.

A batch of E episodes of N videos, (E, N, T, D) per modality, fuses as
E·N videos: attention runs over the T frames of each video (over the N
videos of one side of one episode for the ``video_axis`` encoders), and
batch statistics run over one side of one episode.

Parameter names are the reference's, so a ``ThreeTRXShiftLoopTime`` state
dict (``three_fusion.*``, ``fusion.*``, ``bracnch.transformers.{i}.*``),
and each other class's, loads strictly.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.positional import Dropout, TrainablePE
from ...ops.strm import BottleneckMLP2, MLPMixEnrich
from ...ops.tct import MultiSetTCT
from ...utils.tracing import span


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
    """``depth`` encoder layers under the reference's ``layers`` list, over
    (..., N, T, D): attention runs over the T frames of each of the N
    videos, leading axes folded into N.

    ``video_axis=True`` reproduces the released no-``batch_first`` modules
    (the S3D skeleton encoder, the teacher-half CTX ``Time_Transformer``;
    ``litemkd_tpu/models/teacher/fusion.py:109-135``): torch reads an
    (N, T, D) input as (sequence, batch, feature), so attention runs over
    the N videos at each frame position, separately for each leading
    index (an episode's one side)."""

    def __init__(self, d_model: int, nhead: int, depth: int,
                 dropout: float = 0.1, dim_ff: int = 2048,
                 video_axis: bool = False):
        super().__init__()
        self.video_axis = video_axis
        self.layers = nn.ModuleList(EncoderLayer(d_model, nhead, dim_ff, dropout)
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.video_axis:
            x = x.transpose(-3, -2)
        shape = x.shape
        x = x.reshape(-1, *shape[-2:])
        for layer in self.layers:
            x = layer(x)
        x = x.reshape(shape)
        return x.transpose(-3, -2) if self.video_axis else x


class MultiStreamFusion(nn.Module):
    """N-modality concatenate-encode-project fusion: stream i through
    ``positionEncoding{i+1}``, the streams concatenated along channels, the
    ``transformer_encoder`` (N·d wide; ``nhead`` heads, by default 3 for 3
    streams and 2 otherwise, as the reference's Three/Four/FiveTransfor*
    classes), ``f1`` back to d, then dropout. Streams are (..., N, T, d).

    The released ``FourTransforFusion`` (model.py:1192-1233) has two
    quirks that its bug-faithful preset keeps: ``video_axis`` (see
    :class:`Encoder`) and ``shared_last_pe``, where the last stream goes
    through the previous stream's PE, so no PE of its own exists."""

    def __init__(self, n_streams: int, seq_len: int, d: int = 2048,
                 depth: int = 2, dropout: float = 0.1, nhead: int = 0,
                 video_axis: bool = False, shared_last_pe: bool = False):
        super().__init__()
        self.n_streams = n_streams
        self.n_pes = n_streams - 1 if shared_last_pe else n_streams
        for i in range(self.n_pes):
            setattr(self, f"positionEncoding{i + 1}",
                    TrainablePE(seq_len, d, dropout))
        self.transformer_encoder = Encoder(
            n_streams * d, nhead or (3 if n_streams == 3 else 2), depth,
            dropout, video_axis=video_axis)
        self.f1 = nn.Linear(n_streams * d, d)
        self.drop_out = Dropout(dropout)

    def forward(self, *streams: torch.Tensor) -> torch.Tensor:
        if len(streams) != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got "
                             f"{len(streams)}")
        x = torch.cat([getattr(self, f"positionEncoding{min(i, self.n_pes - 1) + 1}")(m)
                       for i, m in enumerate(streams)], dim=-1)
        return self.drop_out(self.f1(self.transformer_encoder(x)))


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
        with span("encoders"):
            context, target = self.fuse(context_feats), self.fuse(target_feats)
        with span("head"):
            logits = self.bracnch(context, context_labels, target)
        return {"logits": logits}

    def extract(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-video fused features, as the released ``extract_feature``
        dumps them (model.py:1648-1663): later modalities rolled left in
        "reference" mode, unlike ``forward``. Call it in eval mode."""
        return self.fuse(feats, dump=True)


class _BertSelfAttention(nn.Module):
    """The ``query``, ``key`` and ``value`` Linears of BERT's
    ``BertSelfAttention`` (``teacher/code/transformer.py``)."""

    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _BertSelfOutput(nn.Module):
    """BERT's ``BertSelfOutput``: the ``dense`` out-projection and the
    ``LayerNorm`` (eps 1e-5) over the residual."""

    def __init__(self, d: int):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = nn.LayerNorm(d, eps=1e-5)


class CrossAttentionFusion(nn.Module):
    """BERT-style cross attention (``BertAttention``, ``transformer.py:
    57-71``): query = stream 1, key and value = stream 2, ``nhead`` heads,
    dropout on the probabilities and on the out-projection, then the
    LayerNorm over the residual to stream 1. Used by TwoCross, ThreeCross
    and TwoCombinationCTX (model.py:1430-1498, 2022-2053). Streams are
    (..., T, d); the reference's keys, ``self.{query,key,value}`` and
    ``output.{dense,LayerNorm}``."""

    def __init__(self, d: int = 2048, nhead: int = 2, dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.self = _BertSelfAttention(d)
        self.output = _BertSelfOutput(d)
        self.drop_probs = Dropout(dropout)
        self.drop_out = Dropout(dropout)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        *lead, t, d = x1.shape
        h = self.nhead
        q = self.self.query(x1).view(*lead, t, h, d // h)
        k = self.self.key(x2).view(*lead, -1, h, d // h)
        v = self.self.value(x2).view(*lead, -1, h, d // h)
        scores = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(d // h)
        attn = self.drop_probs(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("...hqk,...khd->...qhd", attn, v).reshape(*lead, t, d)
        return self.output.LayerNorm(self.drop_out(self.output.dense(ctx)) + x1)


class SelfEncoderBranch(Encoder):
    """A plain single-head encoder over one stream with no positional
    encoding: ThreeFusion3's ``tran`` (model.py:2565-2580, 3 layers; its
    ``positionEncoding1`` is built and never applied). Attention runs over
    time; ``video_axis=True`` (``ThreeFusion3_videoaxis``) reproduces the
    released layer without ``batch_first``."""

    def __init__(self, d: int = 2048, depth: int = 3, dropout: float = 0.1,
                 video_axis: bool = False):
        super().__init__(d, 1, depth, dropout, video_axis=video_axis)


class BatchStatFusion(nn.Module):
    """BatchTwoFusion (model.py:2607-2619): x shifted and scaled by the
    SCALAR mean and standard deviation of the other stream w, then the
    Linear ``f1``: f1(x + (x − μ_w)/(σ_w + 1e-5)), σ_w = √(var_unbiased +
    1e-16) (the small term keeps the gradient finite on a constant
    stream). Streams are (..., N, T, d); μ and σ run over the trailing
    (N, T, d) axes, one side of one episode (or one extraction batch), as
    the JAX package's per-episode ``vmap`` computes them."""

    def __init__(self, d: int = 2048):
        super().__init__()
        self.f1 = nn.Linear(d, d)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        dims = (-3, -2, -1)
        mu = w.mean(dim=dims, keepdim=True)
        sd = torch.sqrt(w.var(dim=dims, correction=1, keepdim=True) + 1e-16)
        return self.f1(x + (x - mu) / (sd + 1e-5))


class DGAdaIN(nn.Module):
    """Adaptive-instance-norm fusion (model.py:2454-2468): each token of the
    content stream x normalised over its d channels (biased variance, eps
    1e-5, as the reference's ``InstanceNorm1d`` over its (1, N·T, d)
    reshape), then scaled by 1 + ``affine_scale``(w) and shifted by
    ``affine_bias``(w)."""

    def __init__(self, dim: int = 2048):
        super().__init__()
        self.affine_scale = nn.Linear(dim, dim)
        self.affine_bias = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, correction=0, keepdim=True)
        x_n = (x - mu) / torch.sqrt(var + 1e-5)
        return x_n * (1.0 + self.affine_scale(w)) + self.affine_bias(w)


class DGAFusionTeacher(nn.Module):
    """ThreeFusionDGA (model.py:2484-2516, kind ``dga``): the two-stream
    fusion ``fusion1`` of (m2, m3), the AdaIN ``fusion2`` of m1 (the
    normalised content) on that fusion (the style), and the TCT stack.
    ``with_enrich`` (ThreeFusionDGA2, model.py:2518-2554, kind ``dga2``)
    adds the ``mlp1`` MLP-mix enrichment after the AdaIN."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, temp_set=(2,), depth: int = 2,
                 modalities: Sequence[str] = ("rgb", "depth", "flow"),
                 dropout: float = 0.1, with_enrich: bool = False):
        super().__init__()
        self.modalities = tuple(modalities)
        self.fusion1 = TwoStreamFusion(seq_len, in_dim, depth, dropout)
        self.fusion2 = DGAdaIN(in_dim)
        # the released enrichment keeps its own PE dropout at 0.1, whatever
        # trans_dropout says (as the JAX package builds it)
        self.mlp1 = MLPMixEnrich(in_dim, seq_len) if with_enrich else None
        self.bracnch = TrxBranch(way, shot, seq_len, in_dim, out_dim, temp_set,
                                 dropout)

    def fuse(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        m1, m2, m3 = self.modalities
        fused = self.fusion2(feats[m1], self.fusion1(feats[m2], feats[m3]))
        return fused if self.mlp1 is None else self.mlp1(fused)

    def forward(self, context_feats, context_labels, target_feats):
        return {"logits": self.bracnch(self.fuse(context_feats), context_labels,
                                       self.fuse(target_feats))}

    def extract(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-video fused features. Call it in eval mode."""
        return self.fuse(feats)


class _ThreeTranToTwo(nn.Module):
    """ThreeTranToTwo (model.py:2620-2645): three PE'd streams concatenated,
    a 4-layer 3-head encoder over 3d channels and the ``f1`` projection to
    2d, then dropout."""

    def __init__(self, seq_len: int, d: int, depth: int, dropout: float,
                 video_axis: bool):
        super().__init__()
        for i in range(3):
            setattr(self, f"positionEncoding{i + 1}",
                    TrainablePE(seq_len, d, dropout))
        self.transformer_encoder = Encoder(3 * d, 3, depth, dropout,
                                           video_axis=video_axis)
        self.f1 = nn.Linear(3 * d, 2 * d)
        self.drop = Dropout(dropout)

    def forward(self, *streams: torch.Tensor) -> torch.Tensor:
        x = torch.cat([getattr(self, f"positionEncoding{i + 1}")(m)
                       for i, m in enumerate(streams)], dim=-1)
        return self.drop(self.f1(self.transformer_encoder(x)))


class TwoRoadFusionTeacher(nn.Module):
    """ThreeFusionTwoRoad (model.py:2646-2700, kinds ``two_road`` and
    ``two_road_videoaxis``): the ``fusion`` encoder of the three
    modalities gives (..., N, T, 2d); as released, its elements are read
    flat as rows of d, each row's two d/2 halves go through their own
    Linear (``f1``, ``f2``) and bottleneck MLP (``MLP1``, ``MLP2``) and are
    summed, and the N·T·d results are read back as (..., N, T, d) for the
    TCT stack. Rows never cross an episode, so folding E episodes in front
    keeps each episode's order. The released encoder has no
    ``batch_first`` and attends across videos; ``video_axis=True``
    reproduces that, the default attends over time."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, temp_set=(2,), depth: int = 4,
                 modalities: Sequence[str] = ("rgb", "depth", "flow"),
                 dropout: float = 0.1, video_axis: bool = False):
        super().__init__()
        self.modalities = tuple(modalities)
        self.in_dim = in_dim
        half = in_dim // 2
        self.fusion = _ThreeTranToTwo(seq_len, in_dim, depth, dropout,
                                      video_axis)
        self.f1 = nn.Linear(half, half)
        self.f2 = nn.Linear(half, half)
        self.MLP1 = BottleneckMLP2(half)
        self.MLP2 = BottleneckMLP2(half)
        self.bracnch = TrxBranch(way, shot, seq_len, in_dim, out_dim, temp_set,
                                 dropout)

    def fuse(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        d, half = self.in_dim, self.in_dim // 2
        x = self.fusion(*(feats[m] for m in self.modalities))
        lead = x.shape[:-1]                                   # (..., N, T)
        x = x.reshape(-1, d)                                  # (2·…·N·T, d)
        y = self.MLP1(self.f1(x[:, :half])) + self.MLP2(self.f2(x[:, half:]))
        return y.reshape(*lead, d)

    def forward(self, context_feats, context_labels, target_feats):
        return {"logits": self.bracnch(self.fuse(context_feats), context_labels,
                                       self.fuse(target_feats))}

    def extract(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-video fused features. Call it in eval mode."""
        return self.fuse(feats)


# the reference TSF's per-modality heads (model.py:1154-1191), in
# --m1/--m2/--m3 order; a fourth modality on gets ``m<i>_branch``
TSF_BRANCHES = ("m1_branch", "skeleton_branch", "flow_branch")


def tsf_branch_name(i: int) -> str:
    return TSF_BRANCHES[i] if i < len(TSF_BRANCHES) else f"m{i + 1}_branch"


class ScoreFusion(nn.Module):
    """TSF (model.py:1154-1191; ``score_fusion_run.py``, kind ``tsf``): one
    TCT stack per modality over its own features, the logits summed with
    the weights (the reference's --a/--b/--c). Returns ``{"logits",
    "per_modality"}``. It has no ``extract``: score fusion fuses no
    features."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, temp_set=(2,),
                 modalities: Sequence[str] = ("rgb", "depth", "flow"),
                 weights: Sequence[float] = (1.0, 1.0, 1.0),
                 dropout: float = 0.1):
        super().__init__()
        self.modalities = tuple(modalities)
        self.weights = tuple(weights)
        if len(self.weights) != len(self.modalities):
            raise ValueError(
                f"ScoreFusion needs one weight per modality: got "
                f"{len(self.weights)} weights for {self.modalities}")
        for i in range(len(self.modalities)):
            setattr(self, tsf_branch_name(i),
                    TrxBranch(way, shot, seq_len, in_dim, out_dim, temp_set,
                              dropout))

    def branch(self, modality: str) -> TrxBranch:
        return getattr(self, tsf_branch_name(self.modalities.index(modality)))

    def forward(self, context_feats, context_labels, target_feats):
        per_mod = {m: self.branch(m)(context_feats[m], context_labels,
                                     target_feats[m])
                   for m in self.modalities}
        total = None
        for m, w in zip(self.modalities, self.weights):
            total = w * per_mod[m] if total is None else total + w * per_mod[m]
        return {"logits": total, "per_modality": per_mod}


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

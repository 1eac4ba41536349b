"""Plain reference of the MFM fusion teacher (``ThreeTRXShiftLoopTime``,
``teacher/code/multi_fusion.py``): fused = three_fusion(m1, m2, m3) +
fusion(m1, m2 rolled left by ``shirt_num``) + fusion(m1, m3), each fusion a
set of learned positional embeddings, a post-LN transformer encoder over the
frames and a projection back to D; then the TRX head over the fused
features, the summed per-query cross-entropy over the batch size, and SGD.

Parameter names are the reference layout (``three_fusion.*``, ``fusion.*``,
``bracnch.transformers.0.*``). The ops that feed a dropout mask are the
ones the program runs, so the masks, drawn in the same order from a
generator seeded alike, are the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .common import (TRUTH, Dropout, Params, Precision, layer_norm, linear, nll,
                     precision, sgd_, tct_logits)

HEAD = "bracnch.transformers.0"


@dataclass(frozen=True)
class Geometry:
    way: int
    shot: int
    seq_len: int
    tasks_per_batch: int
    learning_rate: float
    dropout: float
    depth: int
    shift: int
    modalities: Sequence[str]


def _attention(x, P: Params, pre: str, heads: int, drop: Dropout):
    n, t, d = x.shape
    qkv = F.linear(x, P[pre + ".in_proj_weight"], P[pre + ".in_proj_bias"])
    q, k, v = qkv.view(n, t, 3, heads, d // heads).unbind(2)
    scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d // heads)
    attn = drop(torch.softmax(scores, dim=-1))
    ctx = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, t, d)
    return linear(ctx, P, pre + ".out_proj")


def _encoder_layer(x, P: Params, pre: str, heads: int, drop: Dropout):
    """Post-LN: x + attention, LayerNorm; x + ReLU FFN, LayerNorm."""
    x = layer_norm(x + drop(_attention(x, P, pre + ".self_attn", heads, drop)),
                   P, pre + ".norm1")
    y = linear(drop(F.relu(linear(x, P, pre + ".linear1"))), P, pre + ".linear2")
    return layer_norm(x + drop(y), P, pre + ".norm2")


def _fusion(P: Params, pre: str, streams, depth: int, drop: Dropout):
    """Learned PE + LayerNorm + dropout per stream, concatenation along
    channels, ``depth`` encoder layers (3 heads for 3 streams, else 2), the
    projection f1, dropout."""
    t = streams[0].shape[-2]
    parts = []
    for i, m in enumerate(streams):
        pe = f"{pre}.positionEncoding{i + 1}"
        emb = P[pe + ".position_embeddings.weight"][:t]
        parts.append(drop(layer_norm(m + emb, P, pe + ".LayerNorm")))
    x = torch.cat(parts, dim=-1)
    shape = x.shape
    x = x.reshape(-1, *shape[-2:])
    heads = 3 if len(streams) == 3 else 2
    for layer in range(depth):
        x = _encoder_layer(x, P, f"{pre}.transformer_encoder.layers.{layer}", heads,
                           drop)
    return drop(linear(x.reshape(shape), P, pre + ".f1"))


def _roll_left(x, s: int):
    return torch.cat([x[..., s:, :], x[..., :s, :]], dim=-2)


def fuse(P: Params, feats: Dict[str, torch.Tensor], g: Geometry, drop: Dropout):
    streams = [feats[m] for m in g.modalities]
    fused = _fusion(P, "three_fusion", streams, g.depth, drop)
    fused = fused + _fusion(P, "fusion", [streams[0], _roll_left(streams[1], g.shift)],
                            g.depth, drop)
    for extra in streams[2:]:
        fused = fused + _fusion(P, "fusion", [streams[0], extra], g.depth, drop)
    return fused


def logits(P: Params, support, labels, queries, g: Geometry, drop: Dropout):
    s = fuse(P, support, g, drop)
    q = fuse(P, queries, g, drop)
    return tct_logits(P, HEAD, s, labels, q, g.way, g.shot, drop)


def train_steps(P: Params, batches: List[Dict], g: Geometry, seed: int,
                prec: Precision = TRUTH, half_batch: bool = False) -> Dict:
    """len(batches) SGD steps of the whole batch at once, as the program
    runs the MFM; the loss of an episode is its summed per-query CE over
    ``tasks_per_batch``. ``half_batch`` (a fault): the first half of the
    episodes, their loss doubled. Returns what
    :func:`portbench.reference.student.train_steps` does."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
    device = next(iter(P.values())).device
    drop = Dropout(g.dropout, torch.Generator(device=device).manual_seed(seed + 2))
    names = [n for n in P if not n.startswith(HEAD + ".norm_v")]
    losses, grad1 = [], None
    with precision(prec):
        for b in batches:
            e = b["support_labels"].shape[0]
            sl = slice(0, e // 2 if half_batch else e)
            out = logits(P, {m: v[sl] for m, v in b["support_feats"].items()},
                         b["support_labels"][sl],
                         {m: v[sl] for m, v in b["query_feats"].items()}, g, drop)
            loss = (nll(out, b["query_labels"][sl]).sum(-1) / g.tasks_per_batch).sum()
            if half_batch:
                loss = loss * 2.0
            gs = torch.autograd.grad(loss, [P[n] for n in names])
            grads = dict(zip(names, gs))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {n: v.clone() for n, v in grads.items()}
            sgd_(P, grads, g.learning_rate)
            del out, loss, gs, grads
    return {"losses": losses, "grad1": grad1,
            "params": {n: P[n].detach() for n in names}}

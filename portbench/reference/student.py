"""Plain reference of the Lite-MKD student (``resnet18_2fc`` trunk, the
``TRX_2fcsup`` head), its frozen ``TRX_2fcsup_fixed`` teacher head, the
``fc_2_sup_dist`` loss and SGD: the training step over micro-batch chunks,
and the eval-mode scorer that serving ships.

Parameter names are the reference layout (``backbone.resnet.<i>...``,
``backbone.fc1``, ``classifier.transformers...``), the names the released
checkpoints use. Everything is fp32 unless :class:`Precision` says
otherwise. BatchNorm in training uses the chunk's batch statistics (biased
variance); in eval mode the running statistics handed in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .common import (TRUTH, Dropout, LowConv, Params, Precision,
                     inter_class_relation, kd_loss, nll, precision, sgd_,
                     support_dk, tct_logits)

TRUNK = "backbone.resnet"
HEAD = "classifier.transformers"


@dataclass(frozen=True)
class Geometry:
    way: int
    shot: int
    seq_len: int
    img_size: int
    tasks_per_batch: int
    micro_batch: int
    learning_rate: float
    temperature: float
    sup_weight: float
    dropout: float


def _conv(x, w, stride: int, pad: int, prec: Precision):
    if prec.trunk != "fp32":
        return LowConv.apply(x, w, stride, pad, prec.trunk)
    return F.conv2d(x, w, None, stride, pad)


def _bn(x, P: Params, prefix: str, stats: Optional[Params], eps: float = 1e-5,
        collect: Optional[Params] = None):
    """BatchNorm: the batch's statistics (biased variance) with ``stats``
    None, else the running ones. ``collect``: a dict that receives each
    layer's batch mean and biased variance."""
    if collect is not None:
        collect[prefix + ".running_mean"] = x.mean(dim=(0, 2, 3))
        collect[prefix + ".running_var"] = x.var(dim=(0, 2, 3), unbiased=False)
    if stats is None:
        return F.batch_norm(x, None, None, P[prefix + ".weight"], P[prefix + ".bias"],
                            True, 0.0, eps)
    return F.batch_norm(x, stats[prefix + ".running_mean"],
                        stats[prefix + ".running_var"], P[prefix + ".weight"],
                        P[prefix + ".bias"], False, 0.0, eps)


def trunk(P: Params, x, prec: Precision, stats: Optional[Params] = None,
          collect: Optional[Params] = None):
    """resnet18 minus its last two layers: (N, 3, H, W) → (N, 512, H/32, W/32).
    ``stats`` None: batch statistics (training); else running ones.
    ``collect``: see :func:`_bn`."""
    bn = lambda x, P, prefix, stats: _bn(x, P, prefix, stats, collect=collect)
    x = _conv(x, P[TRUNK + ".0.weight"], 2, 3, prec)
    x = F.relu(bn(x, P, TRUNK + ".1", stats))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in range(4, 8):
        for block in range(2):
            pre = f"{TRUNK}.{stage}.{block}"
            stride = 2 if stage > 4 and block == 0 else 1
            if pre + ".downsample.0.weight" in P:
                idn = bn(_conv(x, P[pre + ".downsample.0.weight"], stride, 0, prec),
                          P, pre + ".downsample.1", stats)
            else:
                idn = x
            y = F.relu(bn(_conv(x, P[pre + ".conv1.weight"], stride, 1, prec),
                           P, pre + ".bn1", stats))
            y = bn(_conv(y, P[pre + ".conv2.weight"], 1, 1, prec), P, pre + ".bn2",
                    stats)
            x = F.relu(y + idn)
    return x


def features(P: Params, clips, prec: Precision, stats: Optional[Params] = None):
    """uint8 clips (B, T, H, W, 3) → {'f1', 'f2'} (B, T, 2048): the trunk, a
    4×4 adaptive max-pool, the mean of the 16 patches, fc1 and fc2."""
    b, t = clips.shape[:2]
    x = clips.reshape(b * t, *clips.shape[2:]).permute(0, 3, 1, 2).float() / 255.0
    x = trunk(P, x, prec, stats)
    x = F.adaptive_max_pool2d(x, (4, 4)).flatten(2).mean(dim=-1)
    return {f"f{i}": F.linear(x, P[f"backbone.fc{i}.weight"],
                              P[f"backbone.fc{i}.bias"]).reshape(b, t, -1)
            for i in (1, 2)}


def student_logits(P: Params, support_clips, labels, query_clips, g: Geometry,
                   drop: Dropout, prec: Precision, stats: Optional[Params] = None):
    """Branch logits {'kl', 'ce', 'sup'} of a chunk of episodes: one trunk
    batch over support and query clips, the shared TCT on each stream."""
    e, s, q = support_clips.shape[0], support_clips.shape[1], query_clips.shape[1]
    clips = torch.cat([support_clips.reshape(e * s, *support_clips.shape[2:]),
                       query_clips.reshape(e * q, *query_clips.shape[2:])])
    f = features(P, clips, prec, stats)
    sup = {k: v[: e * s].reshape(e, s, *v.shape[1:]) for k, v in f.items()}
    qry = {k: v[e * s:].reshape(e, q, *v.shape[1:]) for k, v in f.items()}
    kl = tct_logits(P, HEAD, sup["f1"], labels, qry["f1"], g.way, g.shot, drop)
    ce = tct_logits(P, HEAD, sup["f2"], labels, qry["f2"], g.way, g.shot, drop)
    return {"kl": kl, "ce": ce, "sup": support_dk(sup["f2"], labels, g.way, g.shot)}


def teacher_logits(T: Params, support_feats, labels, query_feats, g: Geometry,
                   drop: Dropout):
    kl = tct_logits(T, HEAD, support_feats, labels, query_feats, g.way, g.shot, drop)
    return {"kl": kl, "sup": support_dk(support_feats, labels, g.way, g.shot)}


def episode_loss(s, t, labels, g: Geometry) -> torch.Tensor:
    """fc_2_sup_dist of one episode: KD on 'kl', 0.5·DIST on 'sup', CE on
    'ce' over the batch size."""
    return (kd_loss(s["kl"], t["kl"], g.temperature)
            + g.sup_weight * inter_class_relation(s["sup"], t["sup"])
            + nll(s["ce"], labels).mean() / g.tasks_per_batch)


def dropout_generators(seed: int, device) -> List[torch.Generator]:
    """The student's and the teacher's mask generators of a run of
    ``seed``: seeded seed + 2 and seed + 3, as the program documents
    (``train/steps.py`` ``dropout_seeds``)."""
    return [torch.Generator(device=device).manual_seed(seed + k) for k in (2, 3)]


def train_steps(P: Params, T: Params, batches: List[Dict[str, torch.Tensor]],
                g: Geometry, seed: int, prec: Precision = TRUTH,
                replicas: int = 1, exchange: bool = True,
                half_batch: bool = False) -> Dict:
    """Run len(batches) SGD steps from ``P`` (copied) with the frozen
    teacher ``T``. Each step sums the episodes' losses over micro-batch
    chunks (BatchNorm statistics per chunk) and steps once.

    ``replicas`` > 1 follows data-parallel ranks that each hold one chunk
    and a dropout generator seeded alike: every chunk of a step draws its
    masks from the state the generators had at the step's start.
    ``exchange`` False: each replica steps on its own chunk's gradient
    (a fault); the parameters returned are replica 0's. ``half_batch``
    (a fault): the step keeps the first half of its episodes, in their
    chunks, and doubles their loss.

    Returns {'losses': [float], 'grad1': {name: first step's gradient},
    'params': {name: parameters after the last step}}."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
    T = {k: v.detach() for k, v in T.items()}
    gens = dropout_generators(seed, next(iter(P.values())).device)
    sdrop, tdrop = Dropout(g.dropout, gens[0]), Dropout(g.dropout, gens[1])
    names = [n for n in P if not n.startswith(HEAD + ".norm_v")]
    losses, grad1 = [], None
    with precision(prec):
        for step, b in enumerate(batches):
            e = b["support_labels"].shape[0]
            micro = g.micro_batch or e
            start = [gg.get_state() for gg in gens]
            grads = {n: torch.zeros_like(P[n]) for n in names}
            total = 0.0
            kept = e // 2 if half_batch else e
            for c in range(-(-kept // micro)):
                if replicas > 1:
                    for gg, st in zip(gens, start):
                        gg.set_state(st)
                lo = c * micro
                hi = min(lo + micro, kept)
                sl = slice(lo, hi)
                s = student_logits(P, b["support_clips"][sl], b["support_labels"][sl],
                                   b["query_clips"][sl], g, sdrop, prec)
                with torch.no_grad():
                    t = teacher_logits(T, b["support_feats"][sl], b["support_labels"][sl],
                                       b["query_feats"][sl], g, tdrop)
                loss = sum(episode_loss({k: v[i] for k, v in s.items()},
                                        {k: v[i] for k, v in t.items()},
                                        b["query_labels"][sl][i], g)
                           for i in range(hi - lo))
                if half_batch:
                    loss = loss * 2.0
                gs = torch.autograd.grad(loss, [P[n] for n in names])
                if exchange or c == 0:
                    for n, gr in zip(names, gs):
                        grads[n] += gr
                total += float(loss.detach())
                del s, t, loss, gs
            losses.append(total)
            if grad1 is None:
                grad1 = {n: v.clone() for n, v in grads.items()}
            sgd_(P, grads, g.learning_rate)
    return {"losses": losses, "grad1": grad1,
            "params": {n: P[n].detach() for n in names}}


def batch_stats(P: Params, clips) -> Params:
    """Each trunk BatchNorm's mean and biased variance over the frames of
    ``clips`` (B, T, H, W, 3) in training mode: the running statistics a
    served model is given."""
    collect: Params = {}
    with torch.no_grad(), precision(TRUTH):
        x = clips.reshape(-1, *clips.shape[2:]).permute(0, 3, 1, 2).float() / 255.0
        trunk(P, x, TRUTH, None, collect)
    return collect


def score(P: Params, stats: Params, support_clips, labels, query_clips,
          g: Geometry, prec: Precision = TRUTH) -> torch.Tensor:
    """Eval-mode merged logits kl + ce (E, Q, way) of the served scorer."""
    with torch.no_grad(), precision(prec):
        out = student_logits(P, support_clips, labels, query_clips, g,
                             Dropout(0.0, None), prec, stats)
        return out["kl"] + out["ce"]

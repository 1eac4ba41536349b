"""OTAM: ordered temporal alignment with soft-DTW cumulative distances
(port of ``litemkd_tpu/ops/otam.py:21-92``; the reference's ``CNN_OTAM`` /
``OTAM_cum_dist``, ``teacher/code/model.py:3271-3344``).

Per-frame cosine distances between each query and support video, a
smoothed DTW band recursion in both directions, class-mean distances and
softmax(−dist) logits, with an explicit leading episode axis. The
recursion runs over the (static, 8-frame) time axis in Python; row 0 is a
plain running sum and column 0 stays zero, as in the reference's
simplified first row.
"""
from __future__ import annotations

import torch

from .distances import safe_norm
from .dtypes import anchor


def _softmin(lbda: float, *xs: torch.Tensor) -> torch.Tensor:
    """−λ·log Σ exp(−x/λ), computed as the min-subtracted log-sum-exp: the
    same in real arithmetic, but NaN-free where the naive form underflows
    to log(0) (cumulative distances past ~88·λ in fp32)."""
    stacked = torch.stack(xs)
    m = torch.amin(stacked, dim=0)   # ties share the gradient, as jnp.min's
    return m - lbda * torch.log(torch.exp(-(stacked - m) / lbda).sum(dim=0))


def otam_cum_dist(dists: torch.Tensor, lbda: float = 0.1) -> torch.Tensor:
    """dists (..., L, M) frame distances → (...) cumulative distances.

    Pads the last axis with one zero column each side, then runs the
    banded soft-min recursion of the reference (model.py:3271-3300)."""
    L, M = dists.shape[-2:]
    d = torch.nn.functional.pad(dists, (1, 1))
    mp = M + 2
    zeros = torch.zeros_like(d[..., 0, 0])
    prev = [zeros]
    for m in range(1, mp):
        prev.append(d[..., 0, m] + prev[m - 1])
    for l in range(1, L):
        row = [zeros]                 # column 0 is never assigned: stays 0
        row.append(d[..., l, 1] + _softmin(lbda, prev[0], prev[1], row[0]))
        for m in range(2, mp - 1):
            row.append(d[..., l, m] + _softmin(lbda, prev[m - 1], row[m - 1]))
        row.append(d[..., l, mp - 1] + _softmin(lbda, prev[mp - 2],
                                                prev[mp - 1], row[mp - 2]))
        prev = row
    return prev[-1]


def otam_logits(support: torch.Tensor, support_labels: torch.Tensor,
                queries: torch.Tensor, way: int, shot: int, lbda: float = 0.1,
                eps: float = 0.01) -> torch.Tensor:
    """support (E, WS, T, D), labels (E, WS), queries (E, Q, T, D) →
    (E, Q, way) softmaxed OTAM logits.

    The cosine is the reference's ``cos_sim``, x·y/(|x||y| + 0.01)
    (model.py:3260-3268), with the gradient-safe √(Σx² + 1e-16) norm. The
    reference's guard against NaN support features (model.py:3321-3324) is
    kept per episode: the support is sanitised before the math (masking
    only the output would still carry NaN into the backward pass) and a
    bad episode gives zero logits. A NaN in the queries stays NaN, as the
    reference guards only the support."""
    e, q, t, dim = queries.shape
    s = support.shape[1]
    bad = torch.isnan(support).flatten(1).any(dim=1)              # (E,)
    qf = anchor(queries.reshape(e, q * t, dim))
    sf = torch.nan_to_num(anchor(support.reshape(e, s * t, dim)))
    qnorm = safe_norm(qf, -1, keepdims=True)
    snorm = safe_norm(sf, -1, keepdims=True)
    sim = (qf @ sf.transpose(1, 2)) / (qnorm @ snorm.transpose(1, 2) + eps)
    dists = 1.0 - sim.reshape(e, q, t, s, t).permute(0, 1, 3, 2, 4)  # (E,Q,S,T,T)
    cum = otam_cum_dist(dists, lbda) + otam_cum_dist(dists.transpose(-1, -2),
                                                     lbda)
    # class means over the stably sorted support (as the TCT's class_sort)
    order = torch.argsort(support_labels, dim=-1, stable=True)
    cum_sorted = torch.gather(cum, 2, order[:, None, :].expand(e, q, s))
    class_dists = cum_sorted.reshape(e, q, way, shot).mean(dim=-1)
    logits = torch.softmax(-class_dists, dim=-1)
    return torch.where(bad[:, None, None], torch.zeros_like(logits), logits)

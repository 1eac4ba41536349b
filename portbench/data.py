"""Weights and inputs made from ``--seed``, on the device, in a few large
calls: the benchmark's own, handed alike to the program and to the
reference.

Weights follow torch's default initialisers by shape and name: a matrix or
a convolution kernel U(−1/√fan_in, 1/√fan_in), its bias likewise with the
same fan-in, a learned positional table N(0, 1), a norm's scale 1 ± 0.1
and its shift ±0.1 (uniform), so that every parameter differs between
seeds. Episodes are drawn one by one from a generator of (seed, batch,
episode), so a rank that holds a slice of a batch draws the same episodes
as one process that holds all of it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

MASK63 = (1 << 63) - 1


def stream_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream (seed, *keys)."""
    h = seed & MASK63
    for k in keys:
        h = (h * 1_000_003 + k + 0x9E3779B97F4A7C15) & MASK63
    return h


def _fan_in(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def draw_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 stream: int, device) -> Dict[str, torch.Tensor]:
    """fp32 tensors for ``(name, shape)`` pairs, drawn from one uniform and
    one normal call of a generator on ``device`` seeded by (seed, stream)."""
    shapes = list(shapes)
    table = dict(shapes)
    normal = [n for n, s in shapes if "position_embeddings" in n]
    uniform = [n for n, _ in shapes if n not in normal]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    count = lambda names: sum(torch.Size(table[n]).numel() for n in names)
    flat_u = torch.rand(count(uniform), generator=g, device=device) * 2.0 - 1.0
    flat_n = torch.randn(count(normal), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n in uniform:
        shape = torch.Size(table[n])
        u = flat_u[at: at + shape.numel()].view(shape)
        at += shape.numel()
        stem = n.rsplit(".", 1)[0]
        sibling = table.get(stem + ".weight") if n.endswith(".bias") else None
        if n.endswith("in_proj_bias"):
            sibling = table.get(stem + ".in_proj_weight")
        if len(shape) >= 2:
            out[n] = u / _fan_in(tuple(shape)) ** 0.5
        elif sibling is not None and len(sibling) >= 2:
            out[n] = u / _fan_in(tuple(sibling)) ** 0.5
        elif n.endswith("bias"):
            out[n] = 0.1 * u
        else:
            out[n] = 1.0 + 0.1 * u
    at = 0
    for n in normal:
        shape = torch.Size(table[n])
        out[n] = flat_n[at: at + shape.numel()].view(shape)
        at += shape.numel()
    return {n: out[n] for n, _ in shapes}


def load_(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the module's parameters of those names; every
    parameter must be given."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(weights))
    if missing:
        raise KeyError(f"no weights drawn for {missing[:4]}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(weights[n])


def _labels(n: int, way: int, g, device) -> torch.Tensor:
    """n labels, each class n / way times, shuffled."""
    return torch.randperm(n, generator=g, device=device) % way


def clip_episode(geom: Dict, seed: int, batch: int, episode: int, device,
                 queries: int, feat_dim: int = 0) -> Dict[str, torch.Tensor]:
    """One student episode: uint8 clips (S, T, H, W, 3) and (Q, ...), shuffled
    labels, and with ``feat_dim`` the fused teacher features (S, T, D),
    (Q, T, D)."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 7, batch, episode))
    way, s = geom["way"], geom["way"] * geom["shot"]
    frame = (geom["seq_len"], geom["img_size"], geom["img_size"], 3)
    ep = {"support_clips": torch.randint(0, 256, (s, *frame), generator=g,
                                         device=device, dtype=torch.uint8),
          "support_labels": _labels(s, way, g, device),
          "query_clips": torch.randint(0, 256, (queries, *frame), generator=g,
                                       device=device, dtype=torch.uint8),
          "query_labels": _labels(queries, way, g, device)}
    if feat_dim:
        ep["support_feats"] = torch.randn((s, geom["seq_len"], feat_dim), generator=g,
                                          device=device)
        ep["query_feats"] = torch.randn((queries, geom["seq_len"], feat_dim),
                                        generator=g, device=device)
    return ep


def feature_episode(geom: Dict, seed: int, batch: int, episode: int, device,
                    queries: int, feat_dim: int, modalities) -> Dict:
    """One MFM episode: per-modality features (S, T, D) and (Q, T, D), and
    shuffled labels."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 11, batch, episode))
    way, s, t = geom["way"], geom["way"] * geom["shot"], geom["seq_len"]
    return {"support_feats": {m: torch.randn((s, t, feat_dim), generator=g,
                                             device=device) for m in modalities},
            "support_labels": _labels(s, way, g, device),
            "query_feats": {m: torch.randn((queries, t, feat_dim), generator=g,
                                           device=device) for m in modalities},
            "query_labels": _labels(queries, way, g, device)}


def stack(episodes: List[Dict]) -> Dict:
    """Episodes → one batch with a leading episode axis."""
    out = {}
    for k, v in episodes[0].items():
        if isinstance(v, dict):
            out[k] = {m: torch.stack([e[k][m] for e in episodes]) for m in v}
        else:
            out[k] = torch.stack([e[k] for e in episodes])
    return out

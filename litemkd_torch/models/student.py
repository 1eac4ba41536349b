"""Student episode models and the selection registries
(port of ``litemkd_tpu/models/student.py:43-68, 88-116, 144-186, 224-300``),
limited to the entries of the ported slice.

A whole batch of episodes goes through one model call: the trunk sees one
fused (episodes × videos × frames) image batch, context and target clips
together, and the head takes the episode axis as an explicit batch
dimension (it replaces the JAX package's ``nn.vmap``). ``Student`` and
``BatchedStudent`` have the same submodules (``backbone``, ``classifier``),
so their state dicts are the same: the reference torch key layout.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..config import Config
from ..ops.dtypes import anchor_dtype
from .backbones.resnet import ResNetBackbone
from .classifiers.trx import TRX, TRX_2fcsup, TRX_2fcsup_fixed

BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "resnet18_2fc": partial(ResNetBackbone, depth=18, num_fc=2),
    "resnet34_2fc": partial(ResNetBackbone, depth=34, num_fc=2),
}

CLASSIFIERS: Dict[str, Any] = {
    "TRX": TRX,
    "TRX_fixed": TRX,
    "TRX_2fcsup": TRX_2fcsup,
    "TRX_2fcsup_fixed": TRX_2fcsup_fixed,
}


def compute_dtype(cfg: Config) -> torch.dtype:
    """``cfg.model.compute_dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    return getattr(torch, cfg.model.compute_dtype)


def make_classifier(name: str, cfg: Config) -> nn.Module:
    # heads are precision-sensitive (attention, softmax, distances), so they
    # run at the fp32 anchor whatever the trunk dtype
    return CLASSIFIERS[name](
        way=cfg.episode.way, shot=cfg.episode.shot, seq_len=cfg.episode.seq_len,
        in_dim=cfg.model.trans_linear_in_dim,
        out_dim=cfg.model.trans_linear_out_dim,
        set_size=cfg.model.temp_set[0], dropout=cfg.model.trans_dropout,
        compute_dtype=anchor_dtype(compute_dtype(cfg)))


def make_backbone(name: str, cfg: Config) -> nn.Module:
    return BACKBONES[name](out_dim=cfg.model.trans_linear_in_dim,
                           compute_dtype=compute_dtype(cfg))


class BatchedStudent(nn.Module):
    """Student over a batch of episodes: context_clips (E, S, T, H, W, 3),
    context_labels (E, S), target_clips (E, Q, T, H, W, 3) → ``{'logits',
    'context_features', 'target_features'}``, each with a leading E axis."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.backbone = make_backbone(cfg.model.backbone, cfg)
        self.classifier = make_classifier(cfg.model.classifier, cfg)

    def features(self, context_clips, target_clips):
        """Context and target clips through one shared trunk batch, split
        back into (E, S, ...) and (E, Q, ...) features."""
        e, s = context_clips.shape[0], context_clips.shape[1]
        q = target_clips.shape[1]
        clips = torch.cat(
            [context_clips.reshape(e * s, *context_clips.shape[2:]),
             target_clips.reshape(e * q, *target_clips.shape[2:])], dim=0)
        feats = self.backbone(clips)

        def split(f):
            return (f[: e * s].reshape(e, s, *f.shape[1:]),
                    f[e * s:].reshape(e, q, *f.shape[1:]))

        if isinstance(feats, dict):
            pairs = {k: split(v) for k, v in feats.items()}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        return split(feats)

    def forward(self, context_clips, context_labels, target_clips):
        ctx, tgt = self.features(context_clips, target_clips)
        logits = self.classifier(ctx, context_labels, tgt)
        return {"logits": logits, "context_features": ctx,
                "target_features": tgt}


def _drop_episode_axis(x):
    if isinstance(x, dict):
        return {k: _drop_episode_axis(v) for k, v in x.items()}
    return x[0]


class Student(BatchedStudent):
    """Backbone + episodic head over ONE episode: context_clips
    (S, T, H, W, 3), context_labels (S,), target_clips (Q, T, H, W, 3)."""

    def forward(self, context_clips, context_labels, target_clips):
        out = super().forward(context_clips[None], context_labels[None],
                              target_clips[None])
        return _drop_episode_axis(out)

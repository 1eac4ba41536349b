"""Student and teacher episode models and the selection registries
(port of ``litemkd_tpu/models/student.py:43-68, 88-141, 144-186, 224-328``),
limited to the entries of the ported slices: every ``ResNetBackbone``
entry of the JAX registry, and the TRX heads.

A whole batch of episodes goes through one model call: the trunk sees one
fused (episodes × videos × frames) image batch, context and target clips
together, and the head takes the episode axis as an explicit batch
dimension (it replaces the JAX package's ``nn.vmap``). ``Student`` and
``BatchedStudent`` have the same submodules (``backbone``, ``classifier``),
so their state dicts are the same: the reference torch key layout.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..config import Config
from ..ops.dtypes import anchor_dtype
from .backbones.resnet import ResNetBackbone
from .classifiers.trx import TRX, TRX_2fcsup, TRX_2fcsup_fixed

BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "resnet18_student": partial(ResNetBackbone, depth=18, num_fc=1,
                                fc_name="res18_2048"),
    "resnet18_2fc": partial(ResNetBackbone, depth=18, num_fc=2),
    "resnet34_student": partial(ResNetBackbone, depth=34, num_fc=1,
                                fc_name="res18_2048"),
    "resnet34_2fc": partial(ResNetBackbone, depth=34, num_fc=2),
    "resnet50_student": partial(ResNetBackbone, depth=50, num_fc=0),
    # run.py expert trunks at --method resnet18/34 (model.py:551-556):
    # adaptive-max patch-mean features at the trunk width, no fc
    "resnet18_expert": partial(ResNetBackbone, depth=18, num_fc=0),
    "resnet34_expert": partial(ResNetBackbone, depth=34, num_fc=0),
    "resnet50_gap": partial(ResNetBackbone, depth=50, num_fc=0, pool="gap"),
    "resnet18_gap": partial(ResNetBackbone, depth=18, num_fc=0, pool="gap"),
    "resnet50_2fc": partial(ResNetBackbone, depth=50, num_fc=2),
    "meta_baseline": partial(ResNetBackbone, depth=50, num_fc=1, fc_name="fc"),
    "meta_baseline_fc2": partial(ResNetBackbone, depth=50, num_fc=2),
}

CLASSIFIERS: Dict[str, Any] = {
    "TRX": TRX,
    "TRX_fixed": TRX,
    "TRX_2fcsup": TRX_2fcsup,
    "TRX_2fcsup_fixed": TRX_2fcsup_fixed,
}


# teacher selection aliases (reference model_select.py:220-233)
TEACHER_ALIASES: Dict[str, str] = {
    "cos": "cos",
    "e_dist": "e_dist",
    "e_dist_fc2_sup": "e_dist_fc2_sup_fixed",
    "train_teacher": "TRX",
    "test_teacher": "TRX_fixed",
    "train_teacher_TRX_sup": "TRX_sup",
    "test_teacher_TRX_sup_fixed": "TRX_sup_fixed",
    "train_teacher_TRX_2fcsup": "TRX_2fcsup",
    "test_teacher_TRX_2fcsup_fixed": "TRX_2fcsup_fixed",
}


def resolve_teacher(name: str) -> str:
    """Map a reference teacher-selection name (or a classifier name) to its
    ``CLASSIFIERS`` key; raises for a head the port does not have."""
    resolved = TEACHER_ALIASES.get(name, name)
    if resolved not in CLASSIFIERS:
        raise ValueError(
            f"unknown teacher head {name!r}; expected one of "
            f"{sorted(TEACHER_ALIASES)} or a classifier name "
            f"{sorted(CLASSIFIERS)}")
    return resolved


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
                           compute_dtype=compute_dtype(cfg),
                           pallas_bn=cfg.model.pallas_bn,
                           freeze_bn=cfg.model.freeze_bn,
                           remat=cfg.model.remat)


def init_student_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight with torch's default initialisers from
    ``generator``: conv and linear weights and linear biases
    U(-1/√fan_in, 1/√fan_in); BatchNorm and LayerNorm at identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
    return model


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


class BatchedTeacher(nn.Module):
    """Teacher head over a batch of episodes of precomputed fused features:
    context_feats (E, S, T, D), context_labels (E, S), target_feats
    (E, Q, T, D) → ``{'logits': ...}`` with a leading E axis. Its
    parameters are apart from the student's; the train step runs it under
    ``torch.no_grad()``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.classifier = make_classifier(resolve_teacher(cfg.model.teacher),
                                          cfg)

    def forward(self, context_feats, context_labels, target_feats):
        return {"logits": self.classifier(context_feats, context_labels,
                                          target_feats)}


class Teacher(BatchedTeacher):
    """Teacher head over ONE episode: context_feats (S, T, D),
    context_labels (S,), target_feats (Q, T, D)."""

    def forward(self, context_feats, context_labels, target_feats):
        out = super().forward(context_feats[None], context_labels[None],
                              target_feats[None])
        return _drop_episode_axis(out)

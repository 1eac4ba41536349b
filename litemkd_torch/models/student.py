"""Student and teacher episode models and the selection registries
(port of ``litemkd_tpu/models/student.py:43-328``): every backbone and head
of the JAX registries.

A whole batch of episodes goes through one model call: the trunk sees one
fused (episodes × videos × frames) image batch, context and target clips
together, and the head takes the episode axis as an explicit batch
dimension (it replaces the JAX package's ``nn.vmap``). A video-axis
backbone (``*_videoaxis``) attends across the clips of one call, so it
runs once per episode and side instead, as in the JAX package.
``Student`` and ``BatchedStudent`` have the same submodules (``backbone``,
``classifier``), so their state dicts are the same: the reference torch
key layout.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..config import Config
from ..ops.dtypes import anchor_dtype
from ..utils.tracing import span
from .backbones.classifier_net import DeiTTrunk
from .backbones.mobilenet import MobileNetV3Backbone
from .backbones.resnet import FeatureBackbone, ResNetBackbone
from .backbones.skeleton import SkeletonEncoder
from .backbones.strm import STRMBackbone
from .classifiers.ctx import CTXClassifier, CTXVideoAxis
from .classifiers.edist import (CosDistance, EDist, EDist1FCSup, EDistFC2,
                                EDistFC2Sup)
from .classifiers.otam import OTAMClassifier, TRXMulti
from .classifiers.strm import STRM1FCSup, STRMClassifier, STRMClassifierSup
from .classifiers.trx import (TRX, TRX_1fc_sup, TRX_2fc, TRX_2fcsup,
                              TRX_2fcsup_2, TRX_2fcsup_fixed, TRX_sup)
from .teacher.fusion import SelfAttention

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
    "strm18_student": partial(STRMBackbone, depth=18, num_fc=2),
    "strm18_1fc": partial(STRMBackbone, depth=18, num_fc=1),
    "strmbackbone": partial(STRMBackbone, depth=18, num_fc=1),
    "strm50_student": partial(STRMBackbone, depth=50, num_fc=1),
    "cnn_strm": partial(STRMBackbone, depth=50, num_fc=1),
    "mobilenetv3_large": partial(MobileNetV3Backbone, variant="large", num_fc=1),
    "mobilenetv3_large_2fc": partial(MobileNetV3Backbone, variant="large",
                                     num_fc=2),
    "mobilenetv3_small": partial(MobileNetV3Backbone, variant="small", num_fc=1),
    "mobilenetv3_small_2fc": partial(MobileNetV3Backbone, variant="small",
                                     num_fc=2),
    "feature": partial(FeatureBackbone),
    # the *_videoaxis entries reproduce the released S3DEncoder's
    # no-batch_first video-axis attention (model.py:2807)
    "s3d": partial(SkeletonEncoder, video_axis=False),
    "skeleton": partial(SkeletonEncoder, video_axis=False),
    "s3d_videoaxis": partial(SkeletonEncoder, video_axis=True),
    "skeleton_videoaxis": partial(SkeletonEncoder, video_axis=True),
}

CLASSIFIERS: Dict[str, Any] = {
    "TRX": TRX,
    "TRX_fixed": TRX,
    "TRX_sup": TRX_sup,
    "TRX_sup_fixed": TRX_sup,
    "TRX_2fc": TRX_2fc,
    "TRX_2fcsup": TRX_2fcsup,
    "TRX_2fcsup_fixed": TRX_2fcsup_fixed,
    "TRX_1fc_sup": TRX_1fc_sup,
    "TRX_2fcsup_2": TRX_2fcsup_2,
    "TRX_2fcsup_2_fixed": TRX_2fcsup_fixed,
    "cos": CosDistance,
    "e_dist": EDist,
    "e_dist_fc2": EDistFC2,
    "e_dist_fc2_sup": EDistFC2Sup,
    "e_dist_fc2_sup_fixed": EDist1FCSup,
    "e_dist_1fc_sup": EDist1FCSup,
    "strmclassifiers": STRMClassifier,
    "strm_res18": STRMClassifier,
    "strm_res18_sup": STRMClassifierSup,
    "strm_1fc_sup": STRM1FCSup,
    "OTAM": OTAMClassifier,
    "CNN_OTAM": OTAMClassifier,
    "TRX_multi": TRXMulti,
    "TRM": TRXMulti,
    "CTX": CTXClassifier,
    "CTX_videoaxis": CTXVideoAxis,
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
    classifier key; an unknown name raises ``ValueError``."""
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
    """The head ``name`` with the JAX package's keyword arguments
    (``litemkd_tpu/models/student.py:144-172``): the episode geometry, and
    for the TRX, TRX_multi, STRM and CTX heads the widths and dropout, the
    tuple size (``temp_set[0]``; all of ``temp_set`` for TRX_multi; single
    frames for CTX). Those heads run at the fp32 anchor whatever the trunk
    dtype: attention, softmax and distances are precision-sensitive."""
    cls = CLASSIFIERS[name]
    kw = dict(way=cfg.episode.way, shot=cfg.episode.shot,
              seq_len=cfg.episode.seq_len)
    if issubclass(cls, (TRX, TRXMulti, STRMClassifier, CTXClassifier)):
        kw.update(in_dim=cfg.model.trans_linear_in_dim,
                  out_dim=cfg.model.trans_linear_out_dim,
                  dropout=cfg.model.trans_dropout,
                  compute_dtype=anchor_dtype(compute_dtype(cfg)))
    if issubclass(cls, (TRX, STRMClassifier)):
        kw.update(set_size=cfg.model.temp_set[0])
    if issubclass(cls, TRXMulti):
        kw.update(temp_set=cfg.model.temp_set)
    return cls(**kw)


def make_backbone(name: str, cfg: Config) -> nn.Module:
    """The backbone ``name``, with the keyword arguments the JAX package's
    ``make_backbone`` gives it (``litemkd_tpu/models/student.py:189-206``):
    a resnet one gets the BN-kernel switch ``pallas_bn``; an STRM one none,
    and its enrichment blocks' dropout is ``trans_dropout``; a MobileNetV3
    one none (its trunk has flax BatchNorm in the JAX package); a skeleton
    one only the width and the frame count of its PE table; ``feature``
    nothing."""
    entry = BACKBONES[name]
    if entry.func is FeatureBackbone:
        return entry()
    if entry.func is SkeletonEncoder:
        return entry(out_dim=cfg.model.trans_linear_in_dim,
                     seq_len=cfg.episode.seq_len)
    kw = dict(out_dim=cfg.model.trans_linear_in_dim,
              compute_dtype=compute_dtype(cfg), freeze_bn=cfg.model.freeze_bn,
              remat=cfg.model.remat)
    if entry.func is STRMBackbone:
        kw.update(seq_len=cfg.episode.seq_len, dropout=cfg.model.trans_dropout)
    elif entry.func is ResNetBackbone:
        kw.update(pallas_bn=cfg.model.pallas_bn)
    return entry(**kw)


def init_student_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every weight with torch's default initialisers from
    ``generator``: conv and linear weights and linear biases
    U(-1/√fan_in, 1/√fan_in); BatchNorm and LayerNorm at identity;
    embeddings N(0, 1); an attention's stacked ``in_proj_weight``
    xavier-uniform with zero ``in_proj`` and ``out_proj`` biases, as
    ``nn.MultiheadAttention`` does; a DeiT trunk's token parameters
    N(0, 0.02²)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(generator=generator)
            elif isinstance(m, DeiTTrunk):
                m.reset_tokens_(generator)
        for m in model.modules():
            if isinstance(m, SelfAttention):
                three_d, d = m.in_proj_weight.shape
                bound = math.sqrt(6.0 / (three_d + d))
                m.in_proj_weight.uniform_(-bound, bound, generator=generator)
                m.in_proj_bias.zero_()
                m.out_proj.bias.zero_()
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
        back into (E, S, ...) and (E, Q, ...) features. A video-axis
        backbone attends across the clips of one call, so there context and
        target of each episode go through it apart, one call each, as the
        reference's ``S3D.forward`` runs them."""
        e, s = context_clips.shape[0], context_clips.shape[1]
        q = target_clips.shape[1]
        if getattr(self.backbone, "video_axis", False):
            return tuple(torch.stack([self.backbone(c[i]) for i in range(e)])
                         for c in (context_clips, target_clips))
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
        with span("trunk"):
            ctx, tgt = self.features(context_clips, target_clips)
        with span("head"):
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

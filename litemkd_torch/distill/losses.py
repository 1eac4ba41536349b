"""Distillation losses and the logit merge rule (port of
``litemkd_tpu/distill/losses.py:37-429``).

Every named combo is a pure function ``fn(student_logits, teacher_logits,
labels, cfg, tasks_per_batch)`` of ONE episode's logits (``(Q, way)``
matrices, or dicts of them keyed by branch), returning a dict with at least
``{'loss': scalar}``; the train step applies it per episode. The math,
names, registry and returned keys are the JAX package's; ``stop_gradient``
becomes ``.detach()``. The reference's hard-coded ``/16`` is the
``tasks_per_batch`` argument, as in the JAX package.

The paper's main objective is ``fc_2_sup_dist``: ``kd_loss(kl branches) +
0.5 · DIST(support relations) + CE(ce branch)/tpb``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..config import DistillConfig
from ..ops.distances import safe_norm as _safe_norm

Tensor = torch.Tensor
LossDict = Dict[str, Tensor]

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_distiller(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown distiller '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def kd_loss(student: Tensor, teacher: Tensor, temperature: float) -> Tensor:
    """Temperature-scaled KL(teacher ‖ student), summed over classes, mean
    over rows, scaled by T² (Hinton KD)."""
    log_p_s = F.log_softmax(student / temperature, dim=-1)
    p_t = F.softmax(teacher / temperature, dim=-1)
    log_p_t = F.log_softmax(teacher / temperature, dim=-1)
    kl = (p_t * (log_p_t - log_p_s)).sum(dim=-1)
    return kl.mean() * temperature ** 2


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None])[:, 0]


def softmax_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy (``F.cross_entropy``'s default reduction)."""
    return _nll(logits, labels).mean()


def pearson_correlation(x: Tensor, y: Tensor, eps: float = 1e-8) -> Tensor:
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    num = (xc * yc).sum(dim=1)
    den = _safe_norm(xc, 1) * _safe_norm(yc, 1) + eps
    return num / den


def inter_class_relation(y_s: Tensor, y_t: Tensor) -> Tensor:
    """DIST inter-class relation: 1 - mean row-wise Pearson of softmaxed
    logits."""
    return 1.0 - pearson_correlation(F.softmax(y_s, dim=1),
                                     F.softmax(y_t, dim=1)).mean()


def mse(a: Tensor, b: Tensor) -> Tensor:
    return ((a - b) ** 2).mean()


def _focal_weight(proxy_student: Tensor, proxy_teacher: Tensor,
                  labels: Tensor) -> Tensor:
    """WSL-style focal weight: 1 - exp(-CE_s/CE_t), gradients stopped."""
    s = softmax_ce(proxy_student, labels).detach()
    t = softmax_ce(proxy_teacher, labels).detach()
    w = torch.clamp_min(s / (t + 1e-8), 0.0)
    return 1.0 - torch.exp(-w)


# ---------------------------------------------------------------------------
# Single-head distillers (student/teacher logits are plain (Q, way) tensors)
# ---------------------------------------------------------------------------

@register("KD")
def kd(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    ce = cfg.hard_loss_weight * softmax_ce(student, labels) / tpb
    kl = cfg.soft_loss_weight * kd_loss(student, teacher, cfg.temperature)
    return {"hard_loss": ce, "soft_loss": kl, "loss": ce + kl}


@register("ce")
def ce_only(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    return {"loss": softmax_ce(student, labels) / tpb}


# Expert-stage losses: the teacherless CE variants of the per-modality
# expert scripts.

def _sum_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-query CE summed over the episode."""
    return _nll(logits, labels).sum()


@register("TRXLoss")
def trx_expert(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    """The release divides by tasks_per_batch twice; kept faithful."""
    return {"loss": _sum_ce(student, labels) / (tpb * tpb)}


@register("CELoss")
def ce_expert(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    return {"loss": softmax_ce(student, labels) / tpb}


@register("strm_expert")
def strm_expert(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    fr = _sum_ce(student["fr"], labels) / (tpb * tpb)
    pat = _sum_ce(student["pat"], labels) / (tpb * tpb)
    return {"fr_loss": fr, "pat_loss": pat, "loss": fr + 0.1 * pat}


@register("wsl")
def wsl(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    soft = _focal_weight(student, teacher, labels) * kd_loss(student, teacher,
                                                             cfg.temperature)
    hard = softmax_ce(student, labels) / tpb
    soft = cfg.soft_loss_weight * soft
    hard = cfg.hard_loss_weight * hard
    return {"soft_loss": soft, "hard_loss": hard, "loss": soft + hard}


@register("Dist_KD")
def dist_kd(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    ce = cfg.hard_loss_weight * softmax_ce(student, labels) / tpb
    dist = cfg.soft_loss_weight * inter_class_relation(student, teacher)
    return {"soft_loss": dist, "hard_loss": ce, "loss": ce + dist}


# ---------------------------------------------------------------------------
# Dict-logit distillers: student logits are a dict keyed by branch name.
# ---------------------------------------------------------------------------

@register("support_sim")
def support_sim(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    q = student["query"].shape[0]
    sim_s = student["support_set"].reshape(q, -1)
    sim_t = teacher["support_set"].reshape(q, -1)
    sup_kl = cfg.soft_loss_weight_support * kd_loss(sim_s, sim_t, cfg.temperature)
    q_kl = cfg.soft_loss_weight_query * kd_loss(student["query"], teacher["query"],
                                                cfg.temperature)
    ce = cfg.hard_loss_weight * softmax_ce(student["query"], labels) / tpb
    return {"hard_loss": ce, "soft_support_loss": sup_kl, "soft_query_loss": q_kl,
            "loss": ce + sup_kl + q_kl}


@register("KL_feature")
def kl_feature(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    ce = cfg.hard_loss_weight * softmax_ce(student["logits"], labels) / tpb
    kl = cfg.soft_loss_weight * kd_loss(student["logits"], teacher["logits"],
                                        cfg.temperature)
    feat = cfg.feature_loss_weight * mse(student["feature"], teacher["feature"])
    return {"hard_loss": ce, "soft_loss": kl, "feature_loss": feat,
            "loss": ce + kl + feat}


@register("fc_2")
def fc_2(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    ce = cfg.hard_loss_weight * softmax_ce(student["fc_1"], labels) / tpb
    kl = cfg.soft_loss_weight * kd_loss(student["fc_2"], teacher, cfg.temperature)
    return {"hard_loss": ce, "soft_loss": kl, "loss": ce + kl}


@register("fc_2_wsl")
def fc_2_wsl(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    w = _focal_weight(student["fc_1"], student["fc_2"], labels)
    soft = (1.0 + w) * kd_loss(student["fc_2"], teacher, cfg.temperature)
    hard = (2.0 - w) * softmax_ce(student["fc_1"], labels) / tpb
    return {"hard_loss": hard, "soft_loss": soft, "aerfa": w, "loss": soft + hard}


@register("strm")
def strm(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    pat = softmax_ce(student["pat"], labels) / tpb
    fr = softmax_ce(student["fr"], labels) / tpb
    return {"pat_loss": pat, "fr_loss": fr, "loss": 0.1 * pat + fr}


@register("strm_KD")
def strm_kd(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = cfg.soft_loss_weight * kd_loss(student["fr"], teacher, cfg.temperature)
    pat = softmax_ce(student["pat"], labels) / tpb
    fr = softmax_ce(student["fr"], labels) / tpb
    # 'softloss' (no underscore) is the reference's exact key
    return {"pat_loss": pat, "fr_loss": fr, "softloss": kl,
            "loss": 0.1 * pat + fr + kl}


@register("fc_2_sup")
def fc_2_sup(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    w = _focal_weight(student["ce"], student["kl"], labels)
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = kd_loss(student["sup"], teacher["sup"], cfg.temperature) / tpb
    ce = softmax_ce(student["ce"], labels) / tpb
    loss = (1.0 + w) * kl + (2.0 - w) * (0.1 * sup + ce)
    return {"soft_loss": kl, "hard_loss": 0.01 * sup + ce, "loss": loss}


@register("fc_2_sup_dist")
def fc_2_sup_dist(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    """The paper's main objective."""
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce = softmax_ce(student["ce"], labels) / tpb
    loss = kl + cfg.sup_weight * sup + ce
    return {"soft_loss": kl, "hard_loss": cfg.sup_weight * sup + ce, "loss": loss}


@register("fc_2_sup_kl")
def fc_2_sup_kl(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = kd_loss(student["sup"], teacher["sup"], cfg.temperature)
    ce = softmax_ce(student["ce"], labels) / tpb
    loss = kl + 0.5 * sup + ce
    return {"soft_loss": kl, "hard_loss": 0.5 * sup + ce, "loss": loss}


@register("fc_2_sup_dist_cece")
def fc_2_sup_dist_cece(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce_sup = softmax_ce(student["ce"], labels) / tpb
    ce_kl = softmax_ce(student["kl"], labels) / tpb
    loss = kl + ce_kl + 0.5 * sup + ce_sup
    return {"soft_loss": kl, "hard_loss": 0.5 * sup + ce_sup, "loss": loss}


@register("fc_2_sup_klklcece")
def fc_2_sup_klklcece(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = kd_loss(student["sup"], teacher["sup"], cfg.temperature)
    ce_sup = softmax_ce(student["ce"], labels) / tpb
    ce_kl = softmax_ce(student["kl"], labels) / tpb
    loss = kl + ce_kl + 0.5 * sup + ce_sup
    return {"soft_loss": kl, "hard_loss": 0.5 * sup + ce_sup, "loss": loss}


@register("fc_2_sup_distdistcece")
def fc_2_sup_distdistcece(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = inter_class_relation(student["kl"], teacher["kl"])
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce_sup = softmax_ce(student["ce"], labels) / tpb
    ce_kl = softmax_ce(student["kl"], labels) / tpb
    loss = kl + ce_kl + 0.5 * sup + ce_sup
    return {"soft_loss": kl, "hard_loss": 0.5 * sup + ce_sup, "loss": loss}


@register("fc_2_sup_2")
def fc_2_sup_2(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup_ce = inter_class_relation(student["sup_ce"], teacher["sup"])
    sup_kl = inter_class_relation(student["sup_kl"], teacher["sup"])
    ce = softmax_ce(student["ce"], labels) / tpb
    loss = (kl + sup_kl) + ce + sup_ce
    return {"soft_loss": kl + 0.5 * sup_kl, "hard_loss": ce + 0.5 * sup_ce,
            "loss": loss}


@register("fc_2_sup_disver")
def fc_2_sup_disver(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl_sup = kd_loss(student["sup"], teacher["sup"], cfg.temperature)
    dist_q = inter_class_relation(student["kl"], teacher["kl"])
    ce_kl = softmax_ce(student["kl"], labels) / tpb
    ce_sup = softmax_ce(student["ce"], labels) / tpb
    loss = 0.5 * kl_sup + dist_q + ce_sup + ce_kl
    return {"soft_loss": kl_sup, "hard_loss": dist_q + ce_sup, "loss": loss}


@register("fc_2_sup_dist_wsl")
def fc_2_sup_dist_wsl(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    w = _focal_weight(student["ce"], student["kl"], labels)
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce = softmax_ce(student["ce"], labels) / tpb
    loss = (0.5 + w) * kl + (1.5 - w) * (0.5 * sup + ce)
    return {"soft_loss": kl, "hard_loss": 0.5 * sup + ce, "loss": loss}


@register("strm_fc_2_sup_dist")
def strm_fc_2_sup_dist(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl_fr = kd_loss(student["fr1"], teacher["kl"], cfg.temperature)
    kl_pat = kd_loss(student["pat"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce_fr = softmax_ce(student["fr2"], labels) / tpb
    ce_pat = softmax_ce(student["pat"], labels) / tpb
    return {"loss": kl_fr + 0.5 * sup + ce_fr + 0.1 * (kl_pat + ce_pat)}


@register("strm_1fc_sup")
def strm_1fc_sup(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl_fr = kd_loss(student["fr"], teacher["kl"], cfg.temperature)
    kl_pat = kd_loss(student["pat"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce_fr = softmax_ce(student["fr"], labels) / tpb
    ce_pat = softmax_ce(student["pat"], labels) / tpb
    return {"loss": kl_fr + 0.5 * sup + ce_fr + 0.1 * (kl_pat + ce_pat)}


@register("fc_1_sup")
def fc_1_sup(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    ce = softmax_ce(student["kl"], labels) / tpb
    sup = 0.5 * inter_class_relation(student["sup"], teacher["sup"])
    return {"loss": ce + kl + sup}


@register("fc_sup")
def fc_sup(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    ce = softmax_ce(student["kl"], labels) / tpb
    sup = 0.5 * inter_class_relation(student["sup"], teacher["sup"])
    return {"loss": ce + sup}


@register("e_dist_1fc_sup")
def e_dist_1fc_sup(student, teacher, labels, cfg: DistillConfig, tpb: int) -> LossDict:
    kl = kd_loss(student["kl"], teacher["kl"], cfg.temperature)
    sup = inter_class_relation(student["sup"], teacher["sup"])
    ce = softmax_ce(student["kl"], labels) / tpb
    return {"loss": kl + 0.5 * sup + ce}


# ---------------------------------------------------------------------------
# Teacher-side episodic regularizers: the ratio of summed inter-class
# prototype cosines to intra-class video cosines (My_Loss) and the plain
# inter-class cosine sum (My_Loss2), on class-sorted support features
# (way, shot, T, D).
# ---------------------------------------------------------------------------

def _cos(a: Tensor, b: Tensor, eps: float = 1e-8) -> Tensor:
    num = (a * b).sum()
    return num / (_safe_norm(a.reshape(-1), 0) * _safe_norm(b.reshape(-1), 0)
                  + eps)


def inter_class_cosine_ratio(class_sorted_support: Tensor) -> Tensor:
    """My_Loss: Σ_{i<=j} cos(proto_i, proto_j) / Σ_class Σ_{i<=j} cos(v_i, v_j)."""
    protos = class_sorted_support.mean(dim=1)           # (W, T, D)
    w = protos.shape[0]
    cij = sum(_cos(protos[i], protos[j])
              for i in range(w) for j in range(i, w))
    shot = class_sorted_support.shape[1]
    vij = sum(_cos(class_sorted_support[c, i], class_sorted_support[c, j])
              for c in range(w) for i in range(shot) for j in range(i, shot))
    return cij / vij


def inter_class_cosine(class_sorted_support: Tensor) -> Tensor:
    """My_Loss2: the inter-class prototype cosine sum alone."""
    protos = class_sorted_support.mean(dim=1)
    w = protos.shape[0]
    return sum(_cos(protos[i], protos[j])
               for i in range(w) for j in range(i, w))


# ---------------------------------------------------------------------------
# Logit merge rule for accuracy
# ---------------------------------------------------------------------------

def merge_logits(distill_name: str, student_logits):
    """Combine a student's branch logits into the single (..., Q, way) matrix
    the accuracy metric consumes."""
    if isinstance(student_logits, dict):
        if distill_name == "support_sim":
            return student_logits["query"]
        if distill_name == "KL_feature":
            return student_logits["logits"]
        if "kl" in student_logits and "ce" in student_logits:
            return student_logits["kl"] + student_logits["ce"]
        if "fr1" in student_logits:  # strm_fc_2_sup_dist
            return (0.2 * student_logits["pat"] + student_logits["fr1"]
                    + student_logits["fr2"])
        if "fr" in student_logits:   # strm / strm_KD / strm_1fc_sup
            return 0.1 * student_logits["pat"] + student_logits["fr"]
        if "fc_1" in student_logits:
            return student_logits["fc_1"] + student_logits["fc_2"]
        if "kl" in student_logits:
            return student_logits["kl"]
        if "logits" in student_logits:
            return student_logits["logits"]
        raise KeyError(f"cannot merge logits dict with keys {list(student_logits)}")
    return student_logits

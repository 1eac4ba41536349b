"""The MFM fusion teacher's train and eval steps (port of
``litemkd_tpu/train/teacher_steps.py:34-156``; the reference's
``multi_fusion.py:381-494``), and the supervised pretraining state and step
(``teacher_steps.py:222-313``; the reference's ``pretrain/pretrain.py``).

Episodic training of the hierarchical fusion teacher over per-modality
features. The per-episode loss is the reference's: the SUM of the per-query
cross-entropies divided by ``tasks_per_batch`` (``teacher/code/utils.py:
179-194``, ``multi_fusion.py:485``), summed over the episodes of a batch.
The whole batch (16 episodes at the preset) runs as one forward and one
backward, so the TCT kernel launches once a step.

Pretraining is plain mean cross-entropy over class labels for a per-modality
:class:`ActionRecognitionNet`, with the reference's two SGD groups. Expert
episodic training needs no step of its own: it is the student's step with a
resnet backbone, a TRX head and ``TRXLoss``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Config
from ..models.backbones.classifier_net import ActionRecognitionNet
from ..models.student import compute_dtype, init_student_
from ..models.teacher import MFMTeacher, init_mfm_
from ..ops.dtypes import anchor_dtype
from ..ops.positional import bind_dropout_generator
from ..tools.weights import merge_state_dict
from ..utils.metrics import per_episode_accuracy
from .schedule import make_optimizer
from .steps import EpisodeBatch, TrainState, dropout_seeds


def sum_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-query CE summed (not meaned) over the trailing query axis:
    (..., Q, way) × (..., Q) → (...)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).squeeze(-1).sum(-1)


def make_mfm(cfg: Config, kind: str = "mfm") -> MFMTeacher:
    """The fusion teacher of ``kind``; the port has ``"mfm"``
    (``ThreeTRXShiftLoopTime``). It runs at the fp32 anchor (fp64 under a
    float64 config), as the JAX package runs it."""
    if kind != "mfm":
        raise NotImplementedError(
            f"fusion kind {kind!r} is not ported yet (ROADMAP queue 6: TSF, "
            "DGA, two-road, the composer presets and the *_videoaxis "
            "variants); the port has 'mfm'")
    m = cfg.model
    return MFMTeacher(way=cfg.episode.way, shot=cfg.episode.shot,
                      seq_len=cfg.episode.seq_len, in_dim=m.trans_linear_in_dim,
                      out_dim=m.trans_linear_out_dim, temp_set=m.temp_set,
                      depth=m.trans_num, shirt_num=m.shirt_num,
                      modalities=m.modalities, dropout=m.trans_dropout,
                      compute_dtype=anchor_dtype(compute_dtype(cfg)))


def create_mfm_train_state(cfg: Config, device, kind: str = "mfm", *,
                           state_dict: Optional[Dict] = None) -> TrainState:
    """A fresh training state on ``device`` for the fusion teacher of
    ``kind`` (:func:`make_mfm`): random weights from ``cfg.train.seed``
    (:func:`init_mfm_`) or the given reference-layout state dict (strict),
    the optimizer and schedule, and a dropout generator on ``device``
    seeded as the student's (:func:`dropout_seeds`). There is no frozen
    teacher."""
    device = torch.device(device)
    seed = cfg.train.seed
    model = make_mfm(cfg, kind)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_mfm_(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=anchor_dtype(compute_dtype(cfg))).train()
    generator = torch.Generator(device=device).manual_seed(dropout_seeds(seed)[0])
    bind_dropout_generator(model, generator)
    opt, sched = make_optimizer(cfg.train.optimizer, model.parameters(),
                                cfg.train.learning_rate, cfg.train.sch,
                                cfg.train.sch_gamma, cfg.train.tasks_per_batch)
    return TrainState(step=0, episodes_seen=0, model=model, teacher=None,
                      optimizer=opt, scheduler=sched, generator=generator,
                      teacher_generator=None)


def make_mfm_train_step(cfg: Config) -> Callable:
    """``train_step(state, batch) → metrics``: one SGD update on a batch of
    episodes whose clips are ``{modality: (E, N, T, D)}`` features, in one
    forward and one backward. Metrics (device scalars): ``task_loss``, the
    summed loss, and ``accuracy``, the mean per-episode accuracy."""
    tpb = cfg.train.tasks_per_batch

    def train_step(state: TrainState, batch: EpisodeBatch) -> Dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(batch.support_clips, batch.support_labels,
                             batch.query_clips)["logits"]
        total = (sum_ce(logits, batch.query_labels) / tpb).sum()
        total.backward()
        acc = per_episode_accuracy(logits.detach(), batch.query_labels)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        state.episodes_seen += batch.support_labels.shape[0]
        return {"task_loss": total.detach(), "accuracy": acc.mean()}

    return train_step


def make_mfm_eval_step(cfg: Config) -> Callable:
    """``eval_step(model, batch) → (E,)`` per-episode accuracies of an
    eval-mode MFM teacher, computed on the batch's device."""

    def eval_step(model: MFMTeacher, batch: EpisodeBatch) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(batch.support_clips, batch.support_labels,
                           batch.query_clips)["logits"]
            return per_episode_accuracy(logits, batch.query_labels)

    return eval_step


def make_pretrain_model(cfg: Config, num_classes: int,
                        arch: str = "resnet50") -> ActionRecognitionNet:
    """The pretraining classifier of ``arch``: resnet18/34/50
    (``Action_Recognition_Resnet50``) in ``cfg.model.compute_dtype``, with
    ``cfg.model.remat``."""
    if arch == "deit_small":
        raise NotImplementedError(
            "deit_small (ViTClassifier) is not ported yet (ROADMAP queue 5); "
            "the port pretrains resnet18/34/50")
    if arch not in ("resnet18", "resnet34", "resnet50"):
        raise ValueError(f"unknown pretrain arch {arch!r}; choose "
                         "resnet18 | resnet34 | resnet50 | deit_small")
    return ActionRecognitionNet(num_classes, depth=int(arch[len("resnet"):]),
                                compute_dtype=compute_dtype(cfg),
                                remat=cfg.model.remat)


def create_pretrain_state(cfg: Config, device, num_classes: int,
                          lr_groups: Tuple[float, float], steps_per_epoch: int,
                          arch: str = "resnet50",
                          init_state_dict: Optional[Dict] = None) -> TrainState:
    """A fresh pretraining state on ``device``: the model of
    :func:`make_pretrain_model` with random weights from
    ``cfg.train.seed`` and ``init_state_dict`` (a PARTIAL import such as
    :func:`~litemkd_torch.tools.weights.load_pretrain_init`'s trunk) laid
    over them, the reference's ``pretrained=True`` warm start.

    ``lr_groups=(lr_1, lr_2)``: the reference's two SGD groups, the trunk
    (``convnet``) at ``lr_1`` and the head (``fc``) at ``lr_2``, both with
    momentum 0.9 (``pretrain.py:31-32``), each on ``StepLR(step_size=10,
    gamma=0.1)`` stepped at EPOCH START (``pretrain.py:33-38, 108-109``):
    epoch e (``steps_per_epoch`` updates) runs at ``0.1 ** ((e+1) // 10)``
    of its base rate; the scheduler steps once after every update."""
    device = torch.device(device)
    model = make_pretrain_model(cfg, num_classes, arch)
    init_student_(model, torch.Generator().manual_seed(cfg.train.seed))
    if init_state_dict is not None:
        model.load_state_dict(merge_state_dict(model.state_dict(),
                                               init_state_dict), strict=True)
    model.to(device).train()
    lr_1, lr_2 = lr_groups
    opt = torch.optim.SGD([{"params": model.convnet.parameters(), "lr": lr_1},
                           {"params": model.fc.parameters(), "lr": lr_2}],
                          lr=lr_1, momentum=0.9)

    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: 0.1 ** ((step // steps_per_epoch + 1) // 10))
    generator = torch.Generator(device=device).manual_seed(
        dropout_seeds(cfg.train.seed)[0])
    return TrainState(step=0, episodes_seen=0, model=model, teacher=None,
                      optimizer=opt, scheduler=sched, generator=generator,
                      teacher_generator=None)


def make_pretrain_step(cfg: Config) -> Callable:
    """``train_step(state, clips, labels) → metrics``: one SGD update on a
    batch of (B, T, H, W, 3) clips and their (B,) class labels, state
    updated in place. Metrics (device scalars): the mean cross-entropy
    ``loss`` and ``accuracy``. ``episodes_seen`` counts samples here, as in
    the JAX package (it keys the checkpoint files)."""

    def train_step(state: TrainState, clips: torch.Tensor,
                   labels: torch.Tensor) -> Dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(clips)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        state.episodes_seen += clips.shape[0]
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "accuracy": acc}

    return train_step

"""The fusion teachers' train and eval steps and TSF branch grafting (port
of ``litemkd_tpu/train/teacher_steps.py:34-219``; the reference's
``multi_fusion.py:381-494`` and ``score_fusion_run.py``), and the
supervised pretraining state and step (``teacher_steps.py:222-313``; the
reference's ``pretrain/pretrain.py``).

Episodic training of a fusion teacher (the MFM, TSF, DGA, two-road or a
composer preset) over per-modality features. The per-episode loss is the reference's: the SUM of the per-query
cross-entropies divided by ``tasks_per_batch`` (``teacher/code/utils.py:
179-194``, ``multi_fusion.py:485``), summed over the episodes of a batch.
The whole batch (16 episodes at the preset) runs as one forward and one
backward, so the TCT kernel launches once a step for each TCT set of each
head.

Pretraining is plain mean cross-entropy over class labels for a per-modality
:class:`ActionRecognitionNet` or :class:`ViTClassifier`, with the
reference's two SGD groups. Expert
episodic training needs no step of its own: it is the student's step with a
resnet backbone, a TRX head and ``TRXLoss``.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import Config
from ..models.backbones.classifier_net import (ActionRecognitionNet,
                                              ViTClassifier)
from ..models.student import compute_dtype, init_student_
from ..models.teacher import (ComposedFusionTeacher, DGAFusionTeacher,
                              FUSION_PRESET_EXTRACT, FUSION_PRESET_MODULES,
                              FUSION_PRESET_OPTIONS, FUSION_PRESETS,
                              MFMTeacher, ScoreFusion, TwoRoadFusionTeacher,
                              init_mfm_)
from ..models.teacher.composer import preset_base
from ..ops.dtypes import anchor_dtype
from ..ops.positional import bind_dropout_generator
from ..parallel.data_parallel import (all_reduce_grads, check_sync_batch_norm,
                                      reduce_metrics, replicas)
from ..parallel.multihost import DataParallel
from ..parallel.tensor_parallel import sync_replicated_grads_
from ..tools.weights import load_reference_checkpoint, merge_state_dict
from ..utils.metrics import per_episode_accuracy
from .checkpoint import CheckpointManager
from .schedule import make_optimizer
from .steps import EpisodeBatch, TrainState, dropout_seeds


def sum_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-query CE summed (not meaned) over the trailing query axis:
    (..., Q, way) × (..., Q) → (...)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).squeeze(-1).sum(-1)


def make_mfm(cfg: Config, kind: str = "mfm",
             score_weights: Optional[Sequence[float]] = None) -> torch.nn.Module:
    """The fusion teacher of ``kind``, with the JAX package's dispatch and
    messages (``litemkd_tpu/train/teacher_steps.py:40-96``): ``mfm``
    (``ThreeTRXShiftLoopTime``), ``tsf`` (score fusion, ``score_weights``
    one per modality, 1 each by default), ``dga``/``dga2``,
    ``two_road``/``two_road_videoaxis``, a composer preset
    (:data:`FUSION_PRESETS`), or ``otam:<preset>`` (the preset's branches
    under an OTAM head). The MFM runs at the fp32 anchor (fp64 under a
    float64 config); every other kind at fp32, as in the JAX package
    (:func:`teacher_dtype`)."""
    m = cfg.model
    kw = dict(way=cfg.episode.way, shot=cfg.episode.shot,
              seq_len=cfg.episode.seq_len, in_dim=m.trans_linear_in_dim,
              out_dim=m.trans_linear_out_dim, temp_set=m.temp_set,
              modalities=m.modalities, dropout=m.trans_dropout)
    if kind == "tsf":
        return ScoreFusion(weights=(tuple(score_weights)
                                    if score_weights is not None
                                    else (1.0,) * len(m.modalities)), **kw)
    if kind in ("dga", "dga2"):
        return DGAFusionTeacher(depth=m.trans_num, with_enrich=kind == "dga2",
                                **kw)
    if kind in ("two_road", "two_road_videoaxis"):
        # _videoaxis: the released ThreeTranToTwo's no-batch_first encoder
        return TwoRoadFusionTeacher(video_axis=kind.endswith("_videoaxis"),
                                    **kw)
    if kind in FUSION_PRESETS or kind.startswith("otam:"):
        name = kind[5:] if kind.startswith("otam:") else kind
        if name not in FUSION_PRESETS:
            raise ValueError(f"unknown composer preset {name!r}; "
                             f"choose from {sorted(FUSION_PRESETS)}")
        opts = dict(FUSION_PRESET_OPTIONS.get(name, {}))
        if kind.startswith("otam:"):
            opts["head"] = "otam"     # otam: overrides a preset's head option
        return ComposedFusionTeacher(
            branches=FUSION_PRESETS[name], depth=m.trans_num,
            extract_branches=FUSION_PRESET_EXTRACT.get(name),
            module_names=FUSION_PRESET_MODULES[preset_base(name)], **opts, **kw)
    if kind == "mfm":
        return MFMTeacher(depth=m.trans_num, shirt_num=m.shirt_num,
                          compute_dtype=teacher_dtype(cfg, kind), **kw)
    raise ValueError(
        f"unknown fusion kind {kind!r}; choose mfm | tsf | dga | dga2 | "
        f"two_road | two_road_videoaxis | otam:<preset> | one of "
        f"{sorted(FUSION_PRESETS)}")


def teacher_dtype(cfg: Config, kind: str) -> torch.dtype:
    """The dtype a fusion teacher runs at: the MFM at the anchor of the
    config's compute dtype (fp32, fp64 under a float64 config), every other
    kind at fp32, as the JAX package's ``make_mfm`` passes
    ``compute_dtype`` to the MFM alone."""
    return anchor_dtype(compute_dtype(cfg)) if kind == "mfm" else torch.float32


def create_mfm_train_state(cfg: Config, device, kind: str = "mfm", *,
                           score_weights: Optional[Sequence[float]] = None,
                           state_dict: Optional[Dict] = None) -> TrainState:
    """A fresh training state on ``device`` for the fusion teacher of
    ``kind`` (:func:`make_mfm`): random weights from ``cfg.train.seed``
    (:func:`init_mfm_`) or the given reference-layout state dict (strict),
    the optimizer and schedule, and a dropout generator on ``device``
    seeded as the student's (:func:`dropout_seeds`). There is no frozen
    teacher."""
    device = torch.device(device)
    seed = cfg.train.seed
    model = make_mfm(cfg, kind, score_weights)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_mfm_(model, torch.Generator().manual_seed(seed))
    model.to(device=device, dtype=teacher_dtype(cfg, kind)).train()
    generator = torch.Generator(device=device).manual_seed(dropout_seeds(seed)[0])
    bind_dropout_generator(model, generator)
    opt, sched = make_optimizer(cfg.train.optimizer, model.parameters(),
                                cfg.train.learning_rate, cfg.train.sch,
                                cfg.train.sch_gamma, cfg.train.tasks_per_batch)
    return TrainState(step=0, episodes_seen=0, model=model, teacher=None,
                      optimizer=opt, scheduler=sched, generator=generator,
                      teacher_generator=None)


_TCT_PARAMS = ("k_linear.weight", "k_linear.bias", "v_linear.weight",
               "v_linear.bias", "norm_k.weight", "norm_k.bias")


def _expert_sets(path: str, temp_set) -> Dict[Optional[int], Dict]:
    """The TCT sets of an expert: ``{None: flat}`` for a single-set head or
    ``{s: set}`` per tuple size ``s``, each holding the weights that
    :data:`_TCT_PARAMS` names. A ``.pt``/``.pth`` is a run.py expert
    artifact (``transformers.{i}.*``, sets in ``temp_set`` order); a
    directory is a run of the port (its newest ``checkpoint_<n>.pt``,
    ``classifier.transformers.*``, sets in its ``config.json``'s
    ``temp_set`` order)."""
    if str(path).endswith((".pt", ".pth")):
        sd = load_reference_checkpoint(path)[0]
        n = 0
        while f"transformers.{n}.k_linear.weight" in sd:
            n += 1
        if n == 0:
            raise KeyError(f"{path} has no transformers.N TCT sets — "
                           "not a run.py expert checkpoint")
        if n > 1 and (temp_set is None or len(temp_set) != n):
            raise ValueError(
                f"{path} holds {n} TCT sets; pass temp_set with that "
                f"many entries (got {temp_set}) for the ModuleList order")
        prefixes = ({None: "transformers.0"} if n == 1 else
                    {s: f"transformers.{i}" for i, s in enumerate(temp_set)})
    else:
        mgr = CheckpointManager(path)
        if mgr.latest_step() is None:
            raise FileNotFoundError(f"{path} holds no checkpoint_<n>.pt")
        sd = torch.load(mgr.path(mgr.latest_step()), map_location="cpu",
                        weights_only=True)["model_state_dict"]
        head = "classifier.transformers"
        if f"{head}.k_linear.weight" in sd:
            prefixes = {None: head}
        else:
            with open(os.path.join(path, "config.json")) as f:
                temp_set = Config.from_dict(json.load(f)).model.temp_set
            prefixes = {s: f"{head}.{i}" for i, s in enumerate(temp_set)}
            if f"{head}.0.k_linear.weight" not in sd:
                raise KeyError(f"{path}: its checkpoint has no {head} TCT")
    return {s: {k: sd[f"{p}.{k}"] for k in _TCT_PARAMS}
            for s, p in prefixes.items()}


def load_tsf_branches(model: ScoreFusion, branch_ckpts: Dict[str, str],
                      temp_set=None) -> ScoreFusion:
    """Graft separately trained per-modality experts into a TSF teacher's
    branches (the reference's ``score_fusion_run.py``
    ``--rgb/skeleton/flow_test_model_path``; the JAX package's
    ``load_tsf_branches``, ``teacher_steps.py:163-219``): each expert's
    episodic head (``k_linear``, ``v_linear``, ``norm_k`` of every TCT set)
    replaces the branch of its modality, in place.

    ``branch_ckpts``: {modality: path}; a ``.pt``/``.pth`` is a run.py
    expert artifact, a directory a run of the port (see
    :func:`_expert_sets`); ``temp_set`` gives a multi-set ``.pt``'s
    ModuleList order. A single-set expert is replicated into every set of
    the branch; a multi-set one must have the branch's sets."""
    for m, path in branch_ckpts.items():
        key = f"branch_{m}"
        if not isinstance(model, ScoreFusion) or m not in model.modalities:
            raise KeyError(f"{key} not in the {type(model).__name__} teacher "
                           "— is --fusion tsf set?")
        branch = model.branch(m)
        src = _expert_sets(path, temp_set)
        want = set(branch.temp_set)
        if None in src:
            src = {s: src[None] for s in want}
        elif set(src) != want:
            raise ValueError(
                f"temp_set mismatch grafting {path} into {key}: expert "
                f"has sets {sorted(f'tct_{s}' for s in src)}, TSF branch "
                f"expects {sorted(f'tct_{s}' for s in want)}")
        with torch.no_grad():
            for s, tct in zip(branch.temp_set, branch.transformers):
                for k, v in src[s].items():
                    dst = tct.get_parameter(k)
                    if tuple(v.shape) != tuple(dst.shape):
                        raise ValueError(
                            f"grafting {path} into {key}: {k} has shape "
                            f"{tuple(v.shape)}, the branch {tuple(dst.shape)}")
                    dst.copy_(v)
    return model


def make_mfm_train_step(cfg: Config, dp: Optional[DataParallel] = None
                        ) -> Callable:
    """``train_step(state, batch) → metrics``: one SGD update on a batch of
    episodes whose clips are ``{modality: (E, N, T, D)}`` features, in one
    forward and one backward. Metrics (device scalars): ``task_loss``, the
    summed loss, and ``accuracy``, the mean per-episode accuracy.

    With ``dp`` the batch is the share of the episodes of this rank's
    replica, and the gradients and ``task_loss`` are summed over the
    replicas (``accuracy`` averaged). No fusion kind keeps statistics
    across the episodes of a batch (each looks at one side of one episode
    at a time), so nothing else is shared; a module with BatchNorm
    statistics raises. With a model axis the state must be cut over it
    (:func:`~litemkd_torch.train.steps.shard_train_state`, which
    :func:`~litemkd_torch.train.loop.train_loop` applies)."""
    tpb = cfg.train.tasks_per_batch
    world = replicas(dp) if dp is not None else 1

    def train_step(state: TrainState, batch: EpisodeBatch) -> Dict:
        if dp is not None:
            check_sync_batch_norm(state.model, allowed=())
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(batch.support_clips, batch.support_labels,
                             batch.query_clips)["logits"]
        total = (sum_ce(logits, batch.query_labels) / tpb).sum()
        total.backward()
        acc = per_episode_accuracy(logits.detach(), batch.query_labels)
        # each replica's accuracy weighs as its share of the batch
        metrics = {"task_loss": total.detach(), "accuracy": acc.mean() / world}
        if dp is not None:
            sync_replicated_grads_(state.model, dp.axis)
            all_reduce_grads(state.model, dp)
            metrics = reduce_metrics(metrics, dp)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        state.episodes_seen += batch.support_labels.shape[0] * world
        return metrics

    return train_step


def make_mfm_eval_step(cfg: Config) -> Callable:
    """``eval_step(model, batch) → (E,)`` per-episode accuracies of an
    eval-mode fusion teacher, computed on the batch's device."""

    def eval_step(model: torch.nn.Module, batch: EpisodeBatch) -> torch.Tensor:
        with torch.inference_mode():
            logits = model(batch.support_clips, batch.support_labels,
                           batch.query_clips)["logits"]
            return per_episode_accuracy(logits, batch.query_labels)

    return eval_step


def make_pretrain_model(cfg: Config, num_classes: int,
                        arch: str = "resnet50") -> torch.nn.Module:
    """The pretraining classifier of ``arch`` in ``cfg.model.compute_dtype``:
    resnet18/34/50 (``Action_Recognition_Resnet50``, with
    ``cfg.model.remat``) or deit_small (the ``model_distillation`` ViT at
    ``cfg.episode.img_size``)."""
    if arch == "deit_small":
        return ViTClassifier(num_classes, img_size=cfg.episode.img_size,
                             compute_dtype=compute_dtype(cfg))
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
    (``convnet``, for the ViT everything but the head) at ``lr_1`` and the
    head (``fc``) at ``lr_2``, both with
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

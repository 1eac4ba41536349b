"""The distilled student family: a frame trunk and the TRX heads, trained
with its frozen teacher head on uint8 clips and fused teacher features, and
served by the eval-mode scorer. Its plain reference is
:mod:`portbench.reference.student`."""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from portbench import data, flops
from portbench.families import sizes
from portbench.reference import student as ref
from portbench.reference.common import TRUTH, Dropout, Precision

HEAD = ".transformers."
REQUEST = ("support_clips", "support_labels", "query_clips")   # the scorer's arguments
CALIBRATION_BATCH = 1 << 20


def geometry(cfg_file: Dict) -> ref.Geometry:
    s = sizes(cfg_file)
    return ref.Geometry(way=s["way"], shot=s["shot"], seq_len=s["seq_len"],
                        img_size=s["img_size"], tasks_per_batch=s["tasks_per_batch"],
                        micro_batch=s["micro_batch"], learning_rate=s["learning_rate"],
                        temperature=s["temperature"], sup_weight=s["sup_weight"],
                        dropout=s["trans_dropout"])


def learning_rate(cfg_file: Dict) -> float:
    return float(sizes(cfg_file)["learning_rate"])


def episodes(cfg_file: Dict, seed: int, batch: int, lo: int, hi: int, device,
             train: bool = True) -> Dict:
    s = sizes(cfg_file)
    q = s["way"] * (s["query_per_class"] if train else s["query_per_class_test"])
    return data.stack([data.clip_episode(s, seed, batch, i, device, q,
                                         s["trans_linear_in_dim"] if train else 0)
                       for i in range(lo, hi)])


def train_state(cfg, device):
    from litemkd_torch.train.steps import create_train_state
    return create_train_state(cfg, device)


def train_step(cfg, dp=None):
    from litemkd_torch.train.steps import make_train_step
    return make_train_step(cfg, dp)


def reference_steps(cfg_file: Dict, weights: Dict[str, Dict], batches: List[Dict],
                    seed: int, prec: Precision = TRUTH, replicas: int = 1,
                    exchange: bool = True, half_batch: bool = False) -> Dict:
    return ref.train_steps(weights["model"], weights["teacher"], batches,
                           geometry(cfg_file), seed, prec, replicas=replicas,
                           exchange=exchange, half_batch=half_batch)


def scorer(cfg, device):
    """(student, scorer): a ``BatchedStudent`` of ``cfg`` on ``device`` and
    the eval-mode scorer that ``cli.export`` and ``cli.demo`` ship around
    it (``tools.aot.make_serving_fn``)."""
    from litemkd_torch.models import BatchedStudent
    from litemkd_torch.tools.aot import make_serving_fn
    student = BatchedStudent(cfg).to(device)
    return student, make_serving_fn(cfg, student)


def serving_state(cfg_file: Dict, weights: Dict, seed: int, device) -> Dict:
    """The BatchNorm running statistics served with, set alike on both
    sides: each trunk BatchNorm's batch statistics over two episodes of
    their own stream, worked out by the reference in fp32, as a trained
    model's running statistics follow its data."""
    ep = episodes(cfg_file, seed, CALIBRATION_BATCH, 0, 2, device, train=False)
    clips = torch.cat([ep["support_clips"].flatten(0, 1), ep["query_clips"].flatten(0, 1)])
    return ref.batch_stats(weights, clips)


def reference_score(cfg_file: Dict, weights: Dict, state: Dict, req: Dict,
                    prec: Precision = TRUTH) -> torch.Tensor:
    return ref.score(weights, state, req["support_clips"], req["support_labels"],
                     req["query_clips"], geometry(cfg_file), prec)


def _params(s: Dict, teacher: bool) -> Dict[str, torch.Tensor]:
    """Leaves of the reference's student (or teacher head) shapes."""
    d, dk = s["trans_linear_in_dim"], s["trans_linear_out_dim"]
    head = ref.HEAD
    p = {f"{head}.k_linear.weight": (dk, 2 * d), f"{head}.k_linear.bias": (dk,),
         f"{head}.v_linear.weight": (dk, 2 * d), f"{head}.v_linear.bias": (dk,),
         f"{head}.norm_k.weight": (dk,), f"{head}.norm_k.bias": (dk,)}
    if not teacher:
        t = ref.TRUNK
        p[f"{t}.0.weight"], p[f"{t}.1.weight"], p[f"{t}.1.bias"] = (64, 3, 7, 7), (64,), (64,)
        cin = 64
        for stage, width in zip(range(4, 8), (64, 128, 256, 512)):
            for b in range(2):
                pre = f"{t}.{stage}.{b}"
                p[f"{pre}.conv1.weight"] = (width, cin, 3, 3)
                p[f"{pre}.conv2.weight"] = (width, width, 3, 3)
                for bn in ("bn1", "bn2"):
                    p[f"{pre}.{bn}.weight"] = p[f"{pre}.{bn}.bias"] = (width,)
                if cin != width:
                    p[f"{pre}.downsample.0.weight"] = (width, cin, 1, 1)
                    p[f"{pre}.downsample.1.weight"] = p[f"{pre}.downsample.1.bias"] = (width,)
                cin = width
        for i in (1, 2):
            p[f"backbone.fc{i}.weight"], p[f"backbone.fc{i}.bias"] = (d, 512), (d,)
    return {k: torch.empty(v, requires_grad=not teacher) for k, v in p.items()}


def flop_counts(cfg_file: Dict, fake: bool = True) -> Dict[str, Dict[str, float]]:
    """``train_step`` (forward and backward of one step with the frozen
    teacher's forward) and ``serve_request`` (the scorer's forward over one
    test episode), the trunk's convolutions as bf16 and the rest as fp32.
    ``fake`` False computes on real tensors (the tests' check of the fake
    count, at a small size)."""
    s = sizes(cfg_file)
    g = geometry(cfg_file)
    none = Dropout(0.0, None)
    with flops.shapes_only() if fake else contextlib.nullcontext():
        P, T = _params(s, False), _params(s, True)
        e, micro = s["tasks_per_batch"], s["micro_batch"] or s["tasks_per_batch"]
        ep = lambda n, q, feats: data.stack([data.clip_episode(
            s, 0, 0, i, "cpu", q, s["trans_linear_in_dim"] if feats else 0)
            for i in range(n)])
        b = ep(micro, s["way"] * s["query_per_class"], True)
        names = list(P)

        def chunk():
            out = ref.student_logits(P, b["support_clips"], b["support_labels"],
                                     b["query_clips"], g, none, TRUTH)
            with torch.no_grad():
                t = ref.teacher_logits(T, b["support_feats"], b["support_labels"],
                                       b["query_feats"], g, none)
            loss = sum(ref.episode_loss({k: v[i] for k, v in out.items()},
                                        {k: v[i] for k, v in t.items()},
                                        b["query_labels"][i], g)
                       for i in range(micro))
            torch.autograd.grad(loss, [P[n] for n in names])

        def trunk_chunk():
            clips = torch.cat([b["support_clips"].flatten(0, 1), b["query_clips"].flatten(0, 1)])
            x = clips.flatten(0, 1).permute(0, 3, 1, 2).float() / 255.0
            y = ref.trunk(P, x, TRUTH)
            torch.autograd.grad(y.sum(), [P[n] for n in names if n.startswith(ref.TRUNK)])

        chunks = e // micro
        total, trunk = chunks * flops.count(chunk), chunks * flops.count(trunk_chunk)
        r = ep(1, s["way"] * s["query_per_class_test"], False)
        stats = {n.replace(".weight", ".running_mean"): torch.zeros(v.shape)
                 for n, v in P.items() if n.startswith(ref.TRUNK) and v.dim() == 1
                 and n.endswith(".weight")}
        stats.update({k.replace("running_mean", "running_var"): v for k, v in stats.items()})
        serve = flops.count(lambda: ref.score(P, stats, r["support_clips"],
                                              r["support_labels"], r["query_clips"], g))
        x = torch.cat([r["support_clips"].flatten(0, 1), r["query_clips"].flatten(0, 1)])
        with torch.no_grad():
            serve_trunk = flops.count(lambda: ref.trunk(
                P, x.flatten(0, 1).permute(0, 3, 1, 2).float(), TRUTH, stats))
    return {"train_step": {"bf16": trunk, "fp32": total - trunk},
            "serve_request": {"bf16": serve_trunk, "fp32": serve - serve_trunk}}

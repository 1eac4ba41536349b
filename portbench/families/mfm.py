"""The MFM fusion teacher family: transformer encoders fusing rgb, depth and
flow features, then the TRX head, trained on per-modality features. Its
plain reference is :mod:`portbench.reference.mfm`."""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench import data, flops
from portbench.families import sizes
from portbench.reference import mfm as ref
from portbench.reference.common import TRUTH, Dropout, Precision, nll

HEAD = ".transformers."


def geometry(cfg_file: Dict) -> ref.Geometry:
    s = sizes(cfg_file)
    return ref.Geometry(way=s["way"], shot=s["shot"], seq_len=s["seq_len"],
                        tasks_per_batch=s["tasks_per_batch"],
                        learning_rate=s["learning_rate"], dropout=s["trans_dropout"],
                        depth=s["trans_num"], shift=s["shirt_num"],
                        modalities=tuple(s["modalities"]))


def learning_rate(cfg_file: Dict) -> float:
    return float(sizes(cfg_file)["learning_rate"])


def episodes(cfg_file: Dict, seed: int, batch: int, lo: int, hi: int, device,
             train: bool = True) -> Dict:
    s = sizes(cfg_file)
    q = s["way"] * (s["query_per_class"] if train else s["query_per_class_test"])
    return data.stack([data.feature_episode(s, seed, batch, i, device, q,
                                            s["trans_linear_in_dim"], s["modalities"])
                       for i in range(lo, hi)])


def train_state(cfg, device):
    from litemkd_torch.train.teacher_steps import create_mfm_train_state
    return create_mfm_train_state(cfg, device)


def train_step(cfg, dp=None):
    from litemkd_torch.train.teacher_steps import make_mfm_train_step
    return make_mfm_train_step(cfg, dp)


def reference_steps(cfg_file: Dict, weights: Dict[str, Dict], batches: List[Dict],
                    seed: int, prec: Precision = TRUTH, replicas: int = 1,
                    exchange: bool = True, half_batch: bool = False) -> Dict:
    """One step over the whole batch (the MFM runs no micro-batch chunks, so
    ``replicas`` and ``exchange`` change nothing a replica computes)."""
    return ref.train_steps(weights["model"], batches, geometry(cfg_file), seed, prec,
                           half_batch)


def shapes(s: Dict):
    """(name, shape) of the MFM's parameters in the reference layout."""
    d, dk, ff = s["trans_linear_in_dim"], s["trans_linear_out_dim"], 2048
    out = []
    for pre, n in (("three_fusion", len(s["modalities"])), ("fusion", 2)):
        for i in range(n):
            pe = f"{pre}.positionEncoding{i + 1}"
            out += [(f"{pe}.position_embeddings.weight", (s["seq_len"], d)),
                    (f"{pe}.LayerNorm.weight", (d,)), (f"{pe}.LayerNorm.bias", (d,))]
        w = n * d
        for layer in range(s["trans_num"]):
            L = f"{pre}.transformer_encoder.layers.{layer}"
            out += [(f"{L}.self_attn.in_proj_weight", (3 * w, w)),
                    (f"{L}.self_attn.in_proj_bias", (3 * w,)),
                    (f"{L}.self_attn.out_proj.weight", (w, w)),
                    (f"{L}.self_attn.out_proj.bias", (w,)),
                    (f"{L}.linear1.weight", (ff, w)), (f"{L}.linear1.bias", (ff,)),
                    (f"{L}.linear2.weight", (w, ff)), (f"{L}.linear2.bias", (w,)),
                    (f"{L}.norm1.weight", (w,)), (f"{L}.norm1.bias", (w,)),
                    (f"{L}.norm2.weight", (w,)), (f"{L}.norm2.bias", (w,))]
        out += [(f"{pre}.f1.weight", (d, w)), (f"{pre}.f1.bias", (d,))]
    h = ref.HEAD
    out += [(f"{h}.k_linear.weight", (dk, 2 * d)), (f"{h}.k_linear.bias", (dk,)),
            (f"{h}.v_linear.weight", (dk, 2 * d)), (f"{h}.v_linear.bias", (dk,)),
            (f"{h}.norm_k.weight", (dk,)), (f"{h}.norm_k.bias", (dk,))]
    return out


def flop_counts(cfg_file: Dict) -> Dict[str, Dict[str, float]]:
    """``train_step``: forward and backward of one step, all fp32."""
    s = sizes(cfg_file)
    g = geometry(cfg_file)
    with flops.shapes_only():
        P = {n: torch.empty(shape, requires_grad=True) for n, shape in shapes(s)}
        b = data.stack([data.feature_episode(s, 0, 0, i, "cpu", s["way"] * s["query_per_class"],
                                             s["trans_linear_in_dim"], s["modalities"])
                        for i in range(s["tasks_per_batch"])])

        def step():
            out = ref.logits(P, b["support_feats"], b["support_labels"],
                             b["query_feats"], g, Dropout(0.0, None))
            loss = nll(out, b["query_labels"]).sum()
            torch.autograd.grad(loss, list(P.values()))

        return {"train_step": {"fp32": flops.count(step)}}

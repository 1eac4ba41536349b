"""The numbers that decide ``correct``.

Training: the gap of each step's loss, relative to the reference's (the
worst step, and the first alone); the first gradient and the parameters'
change after the checked steps, each by its worst leaf and by its median
leaf: |‖program leaf‖ − ‖reference leaf‖| over the larger of the
reference leaf's norm and the median leaf's, and over every leaf taken as
one vector (``grad_norm_gap``, ``change_norm_gap``: |‖program‖ −
‖reference‖| over ‖reference‖), and so over the body and the head alone
for the first gradient (``grad_norm_body``, ``grad_norm_head``); by
direction, 1 − the cosine between the
program's and the reference's first gradient over the body (trunk and
projections, or fusion encoders) and over the head (the family's
``HEAD``), and between their changes over every leaf; and the program's
``update_gap`` (:mod:`portbench.checked`), each step held to the SGD rule
on its own gradient. A cell's file names which of these it compares; the
others are printed beside. Leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding: a key's bias under
LayerNorm and softmax) are left out, by that rule and not by name.

Serving: the largest gap between a served logit and the reference's, over
the mean spread (max − min over classes) of the reference's logits of
that request's queries.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

QUIET = 1e-3


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(v.double())) for n, v in leaves.items()}


def kept(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = norms(ref_grad)
    med = float(torch.tensor(list(n.values()), dtype=torch.float64).median())
    return [k for k, v in n.items() if v >= QUIET * med]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |‖program‖ − ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn = norms({k: prog[k] for k in leaves})
    rn = norms({k: ref[k] for k in leaves})
    med = float(torch.tensor(list(rn.values()), dtype=torch.float64).median())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def worst_and_median(gaps: Dict[str, float]) -> Tuple[Tuple[float, str], Tuple[float, str]]:
    """((gap, leaf) of the worst leaf, (gap, leaf) of the median leaf)."""
    order = sorted(gaps, key=gaps.get)
    mid = order[(len(order) - 1) // 2]
    return (gaps[order[-1]], order[-1]), (gaps[mid], mid)


def cos_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
            leaves: Sequence[str]) -> float:
    """1 − the cosine between the program's and the reference's vectors of
    ``leaves`` taken as one; 1 where either is all zero (a state left
    unchanged)."""
    dot = sum(float((prog[k].double() * ref[k].double()).sum()) for k in leaves)
    pn = sum(float((prog[k].double() ** 2).sum()) for k in leaves) ** 0.5
    rn = sum(float((ref[k].double() ** 2).sum()) for k in leaves) ** 0.5
    return 1.0 if pn == 0 or rn == 0 else 1.0 - dot / (pn * rn)


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Sequence[str]) -> float:
    """|‖program‖ − ‖reference‖| / ‖reference‖ of ``leaves`` taken as one
    vector."""
    pn = sum(float(torch.linalg.vector_norm(prog[k].double())) ** 2 for k in leaves) ** 0.5
    rn = sum(float(torch.linalg.vector_norm(ref[k].double())) ** 2 for k in leaves) ** 0.5
    return abs(pn - rn) / max(rn, 1e-30)


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def training(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor],
             head: str) -> Dict[str, Tuple[float, str]]:
    """The numbers of a training check. ``prog`` and ``ref`` hold
    'losses', 'grad1' and 'params' (after the checked steps), ``prog``
    also its 'update_gap' (the reference, put in the program's place,
    keeps the rule by construction: 0); ``start`` the parameters before
    the first step; ``head`` marks the head's leaves. Each leaf is
    compared on the reference's device (the program's copies may be on
    the host)."""
    leaves = kept(ref["grad1"])
    at = lambda k, t: t.to(ref["grad1"][k].device)
    g, g_med = worst_and_median(leaf_gaps({k: at(k, prog["grad1"][k]) for k in leaves},
                                          ref["grad1"], leaves))
    pg = {k: at(k, prog["grad1"][k]) for k in leaves}
    dp = {k: at(k, prog["params"][k]).double() - at(k, start[k]).double() for k in leaves}
    dr = {k: ref["params"][k].double() - at(k, start[k]).double() for k in leaves}
    c, c_med = worst_and_median(leaf_gaps(dp, dr, leaves))
    heads = [k for k in leaves if head in k]
    body = [k for k in leaves if head not in k]
    return {"loss_gap": (loss_gap(prog["losses"], ref["losses"]), ""),
            "loss1_gap": (loss_gap(prog["losses"][:1], ref["losses"][:1]), ""),
            "grad_gap": g, "grad_gap_median": g_med,
            "change_gap": c, "change_gap_median": c_med,
            "grad_norm_gap": (norm_gap(pg, ref["grad1"], leaves), f"{len(leaves)} leaves"),
            "grad_norm_body": (norm_gap(pg, ref["grad1"], body), f"{len(body)} leaves"),
            "grad_norm_head": (norm_gap(pg, ref["grad1"], heads), f"{len(heads)} leaves"),
            "change_norm_gap": (norm_gap(dp, dr, leaves), f"{len(leaves)} leaves"),
            "update_gap": prog.get("update_gap", (0.0, "by construction")),
            "grad_cos_body": (cos_gap(pg, ref["grad1"], body), f"{len(body)} leaves"),
            "grad_cos_head": (cos_gap(pg, ref["grad1"], heads), f"{len(heads)} leaves"),
            "change_cos": (cos_gap(dp, dr, leaves), f"{len(leaves)} leaves")}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """(E, Q, W) served and reference logits of one request → the largest
    |gap| over the mean per-query spread of the reference's logits."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    spread = (ref.amax(-1) - ref.amin(-1)).mean()
    return float((prog - ref).abs().max() / max(float(spread), 1e-30))

"""Euclidean and cosine metric heads, ProtoNet style (port of
``litemkd_tpu/models/classifiers/edist.py:15-94``; the reference's
``e_dist.py``, ``e_dist_fc2.py`` and ``COS.py``).

They have no parameters. Calling convention as the TRX heads: a leading
episode axis E, ``head(context, context_labels, target)`` → (E, Q, way)
logits or a dict of branch logits; a two-stream backbone gives
``{'f1', 'f2'}`` features.
"""
from __future__ import annotations

from torch import nn

from ...ops.distances import cosine_logits, edist_logits, support_dk_logits


class EDist(nn.Module):
    """Frame-mean euclidean matcher (``e_dist.py:16-61``)."""

    def __init__(self, way: int, shot: int, seq_len: int):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len

    def forward(self, context, context_labels, target):
        return edist_logits(context, context_labels, target, self.way,
                            self.shot)


class CosDistance(EDist):
    """The reference's 'CosDistance' (``COS.py:23-62``), which computes a
    EUCLIDEAN cdist despite its name, as reproduced here; with
    ``true_cosine`` it is a cosine matcher against class prototypes."""

    def __init__(self, way: int, shot: int, seq_len: int,
                 true_cosine: bool = False):
        super().__init__(way, shot, seq_len)
        self.true_cosine = true_cosine

    def forward(self, context, context_labels, target):
        if self.true_cosine:
            return cosine_logits(context, context_labels, target, self.way,
                                 self.shot)
        return super().forward(context, context_labels, target)


class EDistFC2(EDist):
    """e_dist over both streams → {'fc_1', 'fc_2'} (``e_dist_fc2.py:106-136``)."""

    def forward(self, context, context_labels, target):
        return {k: edist_logits(context[f], context_labels, target[f],
                                self.way, self.shot)
                for k, f in (("fc_1", "f1"), ("fc_2", "f2"))}


class EDistFC2Sup(EDist):
    """e_dist streams and SupportDK → {'kl', 'ce', 'sup'}
    (``e_dist_fc2.py:139-172``)."""

    def forward(self, context, context_labels, target):
        return {
            "kl": edist_logits(context["f1"], context_labels, target["f1"],
                               self.way, self.shot),
            "ce": edist_logits(context["f2"], context_labels, target["f2"],
                               self.way, self.shot),
            "sup": support_dk_logits(context["f2"], context_labels, self.way,
                                     self.shot, self.seq_len),
        }


class EDist1FCSup(EDist):
    """One e_dist stream and SupportDK → {'kl', 'sup'}
    (``e_dist_fc2.py:174-198``); also ``e_dist_fc2_sup_fixed``, the same
    math (l.201-231)."""

    def forward(self, context, context_labels, target):
        return {"kl": super().forward(context, context_labels, target),
                "sup": support_dk_logits(context, context_labels, self.way,
                                         self.shot, self.seq_len)}

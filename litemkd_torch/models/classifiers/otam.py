"""OTAM and multi-tuple-set heads (port of
``litemkd_tpu/models/classifiers/otam.py:18-49``).

``OTAMClassifier`` is ``CNN_OTAM`` (``teacher/code/model.py:3312-3344``),
parameter-free and without a TCT kernel. ``TRXMulti`` (``TRX_multi``,
``TRM``) is the TCT stack over every tuple size of ``temp_set``
(``model.py:886-975, 1094-1128``): the mean of the sets' logits, one
kernel launch per set, the sets at ``transformers.{i}`` in ``temp_set``
order (the keys the JAX package's exporter writes).
"""
from __future__ import annotations

from torch import nn

from ...ops.otam import otam_logits
from ...ops.tct import MultiSetTCT


class OTAMClassifier(nn.Module):
    def __init__(self, way: int, shot: int, seq_len: int, lbda: float = 0.1):
        super().__init__()
        self.way, self.shot, self.lbda = way, shot, lbda

    def forward(self, context, context_labels, target):
        return otam_logits(context, context_labels, target, self.way,
                           self.shot, self.lbda)


class TRXMulti(MultiSetTCT):
    """``MultiSetTCT`` with a head's calling convention."""

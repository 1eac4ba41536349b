"""STRM classifier heads (port of ``litemkd_tpu/models/classifiers/strm.py:
19-74``): the patch stream through :class:`STRMDistance` ('pat') and the
frame stream through a TCT ('fr'), which launches the TCT kernel.

- ``strmclassifiers_resnet18`` (``strmclassifiers_res18.py:257-288``):
  {'pat', 'fr'} from 'distance' and 'trx';
- ``strmclassifiers_resnet18_sup`` (``strm_res18_sup.py:289-327``): one
  shared TCT on 'trx1' and 'trx2' (two launches), and SupportDK on 'trx2'
  → {'pat', 'fr1', 'fr2', 'sup'};
- ``strm_1fc_sup``: {'pat', 'fr', 'sup'} from one frame stream.

Submodules: ``distance`` (``clsW``) and ``transformers``, a leading
episode axis E as in every head of the port.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.distances import support_dk_logits
from ...ops.strm import STRMDistance
from ...ops.tct import TemporalCrossTransformer


class STRMClassifier(nn.Module):
    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, set_size: int = 2, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.transformers = TemporalCrossTransformer(
            way, shot, seq_len, in_dim=in_dim, out_dim=out_dim,
            set_size=set_size, dropout=dropout, compute_dtype=compute_dtype)
        self.distance = STRMDistance(way, shot, seq_len, in_dim=in_dim,
                                     set_size=set_size, dropout=dropout)

    def pat(self, context, context_labels, target):
        return self.distance(context["distance"], context_labels,
                             target["distance"])

    def forward(self, context, context_labels, target):
        return {"pat": self.pat(context, context_labels, target),
                "fr": self.transformers(context["trx"], context_labels,
                                        target["trx"])}


class STRMClassifierSup(STRMClassifier):
    def forward(self, context, context_labels, target):
        return {"pat": self.pat(context, context_labels, target),
                "fr1": self.transformers(context["trx1"], context_labels,
                                         target["trx1"]),
                "fr2": self.transformers(context["trx2"], context_labels,
                                         target["trx2"]),
                "sup": support_dk_logits(context["trx2"], context_labels,
                                         self.way, self.shot, self.seq_len)}


class STRM1FCSup(STRMClassifier):
    def forward(self, context, context_labels, target):
        out = super().forward(context, context_labels, target)
        out["sup"] = support_dk_logits(context["trx"], context_labels,
                                       self.way, self.shot, self.seq_len)
        return out

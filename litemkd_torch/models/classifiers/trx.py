"""TRX classifier heads (port of ``litemkd_tpu/models/classifiers/trx.py:35-58,
92-119``).

Calling convention, with an explicit leading episode axis E::

    head(context_features, context_labels, target_features)
      → (E, Q, way) logits, or a dict of branch logits.

``context_features`` is (E, way·shot, T, D) or a two-stream dict
``{'f1': ..., 'f2': ...}`` from a 2fc backbone; the same holds for targets.
Every head keeps its TCT under the reference's attribute name
``transformers``. "fixed" variants share the architecture; freezing is the
caller's choice.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.distances import support_dk_logits
from ...ops.tct import TemporalCrossTransformer


class TRX(nn.Module):
    """Single temporal-cross-transformer head → (E, Q, way) logits."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, set_size: int = 2, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.way, self.shot, self.seq_len = way, shot, seq_len
        self.transformers = TemporalCrossTransformer(
            way, shot, seq_len, in_dim=in_dim, out_dim=out_dim,
            set_size=set_size, dropout=dropout, compute_dtype=compute_dtype)

    def forward(self, context, context_labels, target):
        return self.transformers(context, context_labels, target)


class TRX_2fcsup(TRX):
    """The paper's student head: one shared TCT turns stream 1 into 'kl'
    and stream 2 into 'ce'; SupportDK on stream 2 gives 'sup'."""

    def forward(self, context, context_labels, target):
        kl = self.transformers(context["f1"], context_labels, target["f1"])
        ce = self.transformers(context["f2"], context_labels, target["f2"])
        sup = support_dk_logits(context["f2"], context_labels, self.way,
                                self.shot, self.seq_len)
        return {"kl": kl, "ce": ce, "sup": sup}


class TRX_2fcsup_fixed(TRX):
    """Teacher head over fused features (one stream): TCT → 'kl',
    SupportDK → 'sup'."""

    def forward(self, context, context_labels, target):
        kl = self.transformers(context, context_labels, target)
        sup = support_dk_logits(context, context_labels, self.way, self.shot,
                                self.seq_len)
        return {"kl": kl, "sup": sup}

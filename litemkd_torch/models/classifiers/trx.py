"""TRX classifier heads (port of ``litemkd_tpu/models/classifiers/trx.py:35-150``).

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

from ...ops.distances import safe_norm, support_dk_logits
from ...ops.dtypes import anchor
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

    def sup(self, context, context_labels):
        return support_dk_logits(context, context_labels, self.way, self.shot,
                                 self.seq_len)


class TRX_sup(TRX):
    """The TCT's query logits ('query') and the (E, Q, way, way) cosine
    similarities between each query's class prototypes, flattened over
    tuples × dk ('support_set'; ``TRX_sup.py:140-229``). The prototypes
    come from the plain version on every device, as in the JAX package
    (:meth:`TemporalCrossTransformer.forward`), so this head launches no
    TCT kernel."""

    def forward(self, context, context_labels, target):
        logits, proto = self.transformers(context, context_labels, target,
                                          return_prototypes=True)
        flat = anchor(proto.flatten(3))
        norm = flat / (safe_norm(flat, -1, keepdims=True) + 1e-8)
        sim = torch.einsum("eqid,eqjd->eqij", norm, norm)
        return {"support_set": sim, "query": logits}


class TRX_2fc(TRX):
    """One shared TCT on both streams → {'fc_1', 'fc_2'}
    (``TRX_2fc.py:163-192``)."""

    def forward(self, context, context_labels, target):
        return {"fc_1": self.transformers(context["f1"], context_labels,
                                          target["f1"]),
                "fc_2": self.transformers(context["f2"], context_labels,
                                          target["f2"])}


class TRX_2fcsup(TRX):
    """The paper's student head: one shared TCT turns stream 1 into 'kl'
    and stream 2 into 'ce'; SupportDK on stream 2 gives 'sup'."""

    def forward(self, context, context_labels, target):
        kl = self.transformers(context["f1"], context_labels, target["f1"])
        ce = self.transformers(context["f2"], context_labels, target["f2"])
        return {"kl": kl, "ce": ce, "sup": self.sup(context["f2"], context_labels)}


class TRX_2fcsup_fixed(TRX):
    """Teacher head over fused features (one stream): TCT → 'kl',
    SupportDK → 'sup'."""

    def forward(self, context, context_labels, target):
        kl = self.transformers(context, context_labels, target)
        return {"kl": kl, "sup": self.sup(context, context_labels)}


# the single-stream student head has the fixed teacher head's body
TRX_1fc_sup = TRX_2fcsup_fixed


class TRX_2fcsup_2(TRX):
    """TRX_2fcsup with SupportDK on both streams → {'kl', 'ce', 'sup_kl',
    'sup_ce'}, the head of the ``fc_2_sup_2`` distiller (recovered in the
    JAX package from the release's compiled ``TRX_2fcsup_2``, whose
    ``_fixed`` teacher variant is :class:`TRX_2fcsup_fixed`)."""

    def forward(self, context, context_labels, target):
        kl = self.transformers(context["f1"], context_labels, target["f1"])
        ce = self.transformers(context["f2"], context_labels, target["f2"])
        return {"kl": kl, "ce": ce,
                "sup_kl": self.sup(context["f1"], context_labels),
                "sup_ce": self.sup(context["f2"], context_labels)}

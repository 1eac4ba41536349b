"""Temporal Cross Transformer, the TRX attention head, and the stack of
them over several tuple sizes (port of ``litemkd_tpu/ops/tct.py:43-150``).

The episode axis is an explicit leading batch dimension (it replaces the
JAX package's ``nn.vmap``), so one kernel launch covers a whole chunk of
episodes.

Faithfulness notes, as in the JAX package:
- the key LayerNorm is applied; the value LayerNorm ``norm_v`` exists as a
  parameter (the reference defines it) and is never applied;
- the softmax runs over the concatenated (shot × tuple) axis of one class;
- support rows are class-sorted with a stable argsort.
"""
from __future__ import annotations

import torch
from torch import nn

from .dtypes import anchor_dtype
from .positional import SinusoidalPE
from .tct_attention import tct_attention, tct_attention_plain
from .tuples import gather_tuples, tuple_indices


def class_sort(support: torch.Tensor, labels: torch.Tensor, way: int,
               shot: int) -> torch.Tensor:
    """Sort support rows by label and reshape to (..., way, shot, ...).

    ``labels`` (..., way·shot) holds each class exactly ``shot`` times; a
    stable argsort groups them so that class w sits at index w.
    ``support`` is (..., way·shot, *rest) with the same leading axes."""
    lead = labels.dim()
    rest = support.shape[lead:]
    order = torch.argsort(labels, dim=-1, stable=True)
    idx = order.reshape(*order.shape, *([1] * len(rest))).expand(
        *order.shape, *rest)
    sorted_support = torch.gather(support, lead - 1, idx)
    return sorted_support.reshape(*labels.shape[:-1], way, shot, *rest)


class TemporalCrossTransformer(nn.Module):
    """One TRX cross-attention head over a batch of episodes.

    Inputs: support (E, way·shot, T, D), labels (E, way·shot), queries
    (E, Q, T, D). Output: logits (E, Q, way), negative squared distances.
    Parameter names are the reference's (``k_linear``, ``v_linear``,
    ``norm_k``, ``norm_v``, ``pe.pe``)."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, set_size: int = 2, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.way, self.shot = way, shot
        self.compute_dtype = compute_dtype
        self.pe = SinusoidalPE(in_dim, max_len=int(seq_len * 1.5),
                               dropout=dropout)
        self.k_linear = nn.Linear(set_size * in_dim, out_dim)
        self.v_linear = nn.Linear(set_size * in_dim, out_dim)
        self.norm_k = nn.LayerNorm(out_dim, eps=1e-5)
        self.norm_v = nn.LayerNorm(out_dim, eps=1e-5)   # unused, as in the reference
        self.register_buffer(
            "tuples", torch.from_numpy(tuple_indices(seq_len, set_size)).long(),
            persistent=False)

    def project(self, support, support_labels, queries):
        """The kernel's four operands: q_k, q_v (E, Q, U, dk) and class-sorted
        class_k, class_v (E, way, shot, U, dk), contiguous, at the anchor
        dtype."""
        adt = anchor_dtype(self.compute_dtype)
        s_t = gather_tuples(self.pe(support), self.tuples).to(self.compute_dtype)
        q_t = gather_tuples(self.pe(queries), self.tuples).to(self.compute_dtype)
        s_k = self.norm_k(self.k_linear(s_t).to(adt))
        q_k = self.norm_k(self.k_linear(q_t).to(adt))
        s_v = self.v_linear(s_t).to(adt)
        q_v = self.v_linear(q_t).to(adt)
        class_k = class_sort(s_k, support_labels, self.way, self.shot)
        class_v = class_sort(s_v, support_labels, self.way, self.shot)
        return (q_k.contiguous(), q_v.contiguous(), class_k.contiguous(),
                class_v.contiguous())

    def forward(self, support, support_labels, queries,
                return_prototypes: bool = False):
        """Logits (E, Q, way); with ``return_prototypes`` also the
        (E, Q, way, U, dk) prototypes, through the plain version on every
        device: the JAX package computes them with ``tct_attention_xla``,
        outside its Pallas kernel (``litemkd_tpu/ops/tct.py:110-115``),
        and the kernel writes no prototypes."""
        ops = self.project(support, support_labels, queries)
        if return_prototypes:
            return tct_attention_plain(*ops, return_proto=True)
        return tct_attention(*ops)


class MultiSetTCT(nn.Module):
    """One :class:`TemporalCrossTransformer` per entry of ``temp_set``, in
    ``temp_set`` order, under the reference's ``transformers`` ModuleList;
    the logits are the mean of the sets' logits (``MultiSetTCT``,
    ``litemkd_tpu/ops/tct.py:122-150``). Each set launches the TCT kernel
    once for the whole episode batch."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int = 2048,
                 out_dim: int = 1152, temp_set=(2,), dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transformers = nn.ModuleList(
            TemporalCrossTransformer(way, shot, seq_len, in_dim=in_dim,
                                     out_dim=out_dim, set_size=s,
                                     dropout=dropout,
                                     compute_dtype=compute_dtype)
            for s in temp_set)

    def forward(self, support, support_labels, queries):
        return torch.stack([t(support, support_labels, queries)
                            for t in self.transformers], dim=-1).mean(dim=-1)

"""The ``model`` (tensor-parallel) axis of the mesh: the wide projections
cut over the ranks of a model group, as the JAX package shards them over
its mesh's ``model`` axis (``litemkd_tpu/parallel/mesh.py:47-95``, XLA
inserting the collectives).

Each rank of a model group holds the same replicated activations and
parameters, and its shard of every weight that
:func:`~litemkd_torch.parallel.mesh.param_spec` names. Three collectives
over the model group carry the arithmetic, each an autograd function:

- :func:`copy_in`: forward identity, backward all-reduce. It opens every
  column layer: each rank's input gradient covers its shard of the output
  only, and their sum is the gradient of the replicated input (without it
  the parameters upstream would get 1/M of theirs);
- :func:`gather_out`: forward all-gather along an axis, backward the own
  slice;
- :func:`reduce_out`: forward all-reduce, backward identity. It closes a
  row layer.

and :func:`scatter_in`, a slice of a replicated tensor (forward the own
slice, backward all-gather), where a replicated bias or activation meets
a sharded one.

A lone column layer (a TCT's ``k_linear``/``v_linear``, a backbone's
``fc1``/``fc2``, a squeeze-excite's, a stream fusion's ``f1``) gathers its
output: ``norm_k``, the TCT kernel and the heads' reshapes need the full
width. An encoder layer keeps its hidden sharded between the paired layers
and all-reduces once after the row layer, as XLA does: ``linear1`` → ReLU
→ ``linear2``, and q/k/v → attention → ``out_proj``. Attention is local to
a rank's heads where ``nhead`` divides over the group; elsewhere (the MFM's
3-head encoder at M = 2 or 4) q, k and v are gathered before the scores.
Dropout on a sharded hidden draws the full-width mask from the shared
generator and keeps its slice, so the ranks of a group draw alike and
their replicated activations stay identical.

The replicated parameters' gradients are computed alike on every rank of
a group but not always bitwise so (cuDNN's convolution backward is
nondeterministic), so the train steps broadcast them from the group's
first rank (:func:`sync_replicated_grads_`) and the replicas stay equal.

:func:`shard_model` swaps the matched modules in place; each keeps the
Parameter objects of the module it replaces, cut to this rank's shard, so
an optimizer built before still holds them (:func:`shard_optimizer_state_`
cuts its state alike). A model is built, initialised and loaded on one
process and then sharded; :func:`full_state_dict` and
:func:`full_optimizer_state_dict` gather it back to the one-process layout.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..ops.positional import Dropout
from .mesh import COLUMN, ROW, ParamSpec, divides, param_spec


class ModelAxis(NamedTuple):
    """A rank's model group: the process ``group``, its ``size`` M and the
    rank's ``index`` in it."""

    group: object
    size: int
    index: int


def _gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    w = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * w, w).contiguous()


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.group)
        return g, None


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axis, ctx.dim), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        if x.is_contiguous():
            ctx.mark_dirty(x)    # the partial product is summed in place
        else:
            x = x.contiguous()
        dist.all_reduce(x, group=axis.group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


def copy_in(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyIn.apply(x, axis)


def gather_out(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _GatherOut.apply(x, axis, dim)


def reduce_out(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceOut.apply(x, axis)


def scatter_in(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    return _ScatterIn.apply(x, axis, dim)


# ---------------------------------------------------------------------------
# shards of one tensor
# ---------------------------------------------------------------------------

def shard_tensor(full: torch.Tensor, spec: ParamSpec, axis: ModelAxis
                 ) -> torch.Tensor:
    """This rank's shard of a full tensor: each of ``spec.blocks`` blocks
    along ``spec.dim`` cut in M, the rank's pieces stacked again."""
    return torch.cat([_slice(b, axis, spec.dim)
                      for b in full.chunk(spec.blocks, spec.dim)], spec.dim)


def unshard_tensor(parts: List[torch.Tensor], spec: ParamSpec) -> torch.Tensor:
    """The full tensor of every rank's shard (in rank order)."""
    blocks = [p.chunk(spec.blocks, spec.dim) for p in parts]
    return torch.cat([torch.cat([b[i] for b in blocks], spec.dim)
                      for i in range(spec.blocks)], spec.dim)


def _shard_param_(p: nn.Parameter, spec: ParamSpec, axis: ModelAxis) -> None:
    p.tp_spec, p.tp_full_shape = spec, tuple(p.shape)
    p.data = shard_tensor(p.data, spec, axis)


# ---------------------------------------------------------------------------
# the parallel modules
# ---------------------------------------------------------------------------

class ColumnParallelLinear(nn.Module):
    """A Linear (or a 1×1 convolution) whose output features are cut over
    the model group: ``weight`` is this rank's rows, ``bias`` stays whole
    (replicated, as the JAX rules shard kernels only) and each rank adds
    its slice in the product. ``gather``: the
    output is all-gathered to the full width; else it stays this rank's
    slice, for a :class:`RowParallelLinear` to close."""

    def __init__(self, layer: nn.Module, axis: ModelAxis, gather: bool = True):
        super().__init__()
        self.axis, self.gather = axis, gather
        _shard_param_(layer.weight, ParamSpec(COLUMN, 0), axis)
        self.weight, self.bias = layer.weight, layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.flatten(1).to(x.dtype)
        b = None if self.bias is None else scatter_in(self.bias.to(x.dtype),
                                                      self.axis, 0)
        y = F.linear(copy_in(x, self.axis), w, b)
        return gather_out(y, self.axis) if self.gather else y


class RowParallelLinear(nn.Module):
    """A Linear whose input features are cut over the model group: its
    input is this rank's slice, the partial products are all-reduced, then
    the whole (replicated) bias is added."""

    def __init__(self, layer: nn.Linear, axis: ModelAxis):
        super().__init__()
        self.axis = axis
        _shard_param_(layer.weight, ParamSpec(ROW, 1), axis)
        self.weight, self.bias = layer.weight, layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_out(F.linear(x, self.weight), self.axis)
        return y if self.bias is None else y + self.bias


class ShardedDropout(Dropout):
    """:class:`Dropout` on a tensor that is this rank's slice along ``dim``
    of a replicated one: the mask of the full shape is drawn (so the group
    draws alike and a one-process run draws the same) and sliced."""

    def __init__(self, p: float, axis: ModelAxis, dim: int):
        super().__init__(p)
        self.axis, self.dim = axis, dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = _empty_like_full(x, self.dim, self.axis.size).bernoulli_(
            1.0 - self.p, generator=self.generator)
        keep = _slice(keep, self.axis, self.dim)
        return torch.where(keep.bool(), x / (1.0 - self.p), 0.0)


def _empty_like_full(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """What ``torch.empty_like`` gives for the full tensor of which ``x``
    is a slice along ``dim``: the full shape in ``x``'s memory order. A
    mask is drawn in memory order, so this draws the one-process mask."""
    dim = dim % x.dim()
    order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
    shape = list(x.shape)
    shape[dim] *= size
    buf = x.new_empty([shape[i] for i in order])
    return buf.permute([order.index(i) for i in range(x.dim())])


def _sharded_dropout(drop: Dropout, axis: ModelAxis, dim: int) -> ShardedDropout:
    out = ShardedDropout(drop.p, axis, dim)
    out.generator = drop.generator
    out.train(drop.training)
    return out


class ParallelSelfAttention(nn.Module):
    """:class:`~litemkd_torch.models.teacher.fusion.SelfAttention` with the
    q, k and v thirds of ``in_proj_weight`` cut over the model group and
    ``out_proj`` a :class:`RowParallelLinear`. Where the heads divide over
    the group each rank attends with its own heads; elsewhere q, k and v
    are gathered, every rank attends with all heads, and the context is
    sliced again for ``out_proj``."""

    def __init__(self, attn: nn.Module, axis: ModelAxis):
        super().__init__()
        self.axis, self.nhead = axis, attn.nhead
        self.local_heads = attn.nhead % axis.size == 0
        _shard_param_(attn.in_proj_weight, ParamSpec(COLUMN, 0, 3), axis)
        self.in_proj_weight, self.in_proj_bias = (attn.in_proj_weight,
                                                  attn.in_proj_bias)
        self.out_proj = RowParallelLinear(attn.out_proj, axis)
        self.drop_probs = (_sharded_dropout(attn.drop_probs, axis, 1)
                           if self.local_heads else attn.drop_probs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        h, m = self.nhead, self.axis.size
        hd = d // h
        bias = scatter_in(self.in_proj_bias.view(3, d), self.axis, 1)
        qkv = F.linear(copy_in(x, self.axis), self.in_proj_weight,
                       bias.reshape(-1)).view(n, t, 3, d // m)
        if self.local_heads:
            q, k, v = qkv.view(n, t, 3, h // m, hd).unbind(2)
        else:
            q, k, v = gather_out(qkv, self.axis).view(n, t, 3, h, hd).unbind(2)
        scores = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
        attn = self.drop_probs(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("nhqk,nkhd->nqhd", attn, v).reshape(n, t, -1)
        if not self.local_heads:
            ctx = scatter_in(ctx, self.axis)
        return self.out_proj(ctx)


def shard_model(model: nn.Module, axis: ModelAxis) -> nn.Module:
    """Swap, in place, every module that :func:`param_spec` matches for its
    parallel counterpart over ``axis`` (JAX's divisibility fallback
    leaves a layer whose cut axis does not divide M whole) and mark
    ``model`` as sharded. Returns ``model``; a second call does nothing."""
    from ..models.teacher.fusion import EncoderLayer, SelfAttention
    if getattr(model, "tp_axis", None) is not None:
        return model
    for mod in list(model.modules()):
        if isinstance(mod, EncoderLayer):
            spec = param_spec(mod, "linear1")
            if divides(mod.linear1.weight.shape, spec, axis.size):
                mod.linear1 = ColumnParallelLinear(mod.linear1, axis,
                                                   gather=False)
                mod.linear2 = RowParallelLinear(mod.linear2, axis)
                mod.dropout = _sharded_dropout(mod.dropout, axis, -1)
        for name, child in list(mod.named_children()):
            if isinstance(child, SelfAttention):
                spec = param_spec(child, "in_proj_weight")
                if divides(child.in_proj_weight.shape, spec, axis.size):
                    setattr(mod, name, ParallelSelfAttention(child, axis))
                continue
            # the pairs of an encoder layer are cut above
            if isinstance(mod, (EncoderLayer, SelfAttention)) or \
                    not isinstance(child, (nn.Linear, nn.Conv2d)):
                continue
            spec = param_spec(mod, name)
            if spec is not None and spec.kind == COLUMN and \
                    divides(child.weight.shape, spec, axis.size):
                setattr(mod, name, ColumnParallelLinear(child, axis))
    model.tp_axis = axis
    return model


# ---------------------------------------------------------------------------
# state in the one-process layout
# ---------------------------------------------------------------------------

def sharded_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters of ``model`` that are cut over its model group, by
    state-dict key."""
    return {n: p for n, p in model.named_parameters()
            if getattr(p, "tp_spec", None) is not None}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered from the model
    group: the keys and shapes of the unsharded model. A collective over
    the group (every rank of it calls it); an unsharded model gives its
    own state dict."""
    sd = model.state_dict()
    axis = getattr(model, "tp_axis", None)
    if axis is None:
        return sd
    for name, p in sharded_parameters(model).items():
        sd[name] = unshard_tensor(_parts(sd[name], axis), p.tp_spec)
    return sd


def shard_state_dict(model: nn.Module, full: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The state dict of the sharded ``model`` cut from a one-process
    ``full`` one (for ``load_state_dict``)."""
    axis = getattr(model, "tp_axis", None)
    if axis is None:
        return full
    out = dict(full)
    for name, p in sharded_parameters(model).items():
        out[name] = shard_tensor(full[name], p.tp_spec, axis)
    return out


def _parts(t: torch.Tensor, axis: ModelAxis) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return parts


def _optimizer_params(opt: torch.optim.Optimizer) -> List[nn.Parameter]:
    return [p for g in opt.param_groups for p in g["params"]]


def _per_param(state: dict, p: nn.Parameter, shape, fn) -> dict:
    return {k: fn(v) if torch.is_tensor(v) and tuple(v.shape) == tuple(shape)
            and v.dim() > 0 else v for k, v in state.items()}


def full_optimizer_state_dict(opt: torch.optim.Optimizer,
                              axis: Optional[ModelAxis]) -> dict:
    """``opt.state_dict()`` with the state of every sharded parameter
    gathered (a collective over the model group), in the layout of the
    optimizer of the unsharded model."""
    sd = opt.state_dict()
    if axis is None:
        return sd
    params = _optimizer_params(opt)
    state = {}
    for i, st in sd["state"].items():
        p = params[i]
        spec = getattr(p, "tp_spec", None)
        state[i] = st if spec is None else _per_param(
            st, p, p.shape, lambda v: unshard_tensor(_parts(v, axis), spec))
    return {**sd, "state": state}


def shard_optimizer_state_dict(opt: torch.optim.Optimizer, full: dict,
                               axis: Optional[ModelAxis]) -> dict:
    """A one-process optimizer state dict cut for ``opt``, whose parameters
    are sharded (for ``opt.load_state_dict``)."""
    if axis is None:
        return full
    params = _optimizer_params(opt)
    state = {}
    for i, st in full["state"].items():
        p = params[i]
        spec = getattr(p, "tp_spec", None)
        state[i] = st if spec is None else _per_param(
            st, p, p.tp_full_shape, lambda v: shard_tensor(v, spec, axis))
    return {**full, "state": state}


def shard_optimizer_state_(opt: torch.optim.Optimizer, axis: ModelAxis) -> None:
    """Cut, in place, the state that ``opt`` already holds for parameters
    that were sharded after it was built."""
    for p in _optimizer_params(opt):
        spec = getattr(p, "tp_spec", None)
        if spec is not None and p in opt.state:
            opt.state[p] = _per_param(opt.state[p], p, p.tp_full_shape,
                                      lambda v: shard_tensor(v, spec, axis))


def sync_replicated_grads_(model: nn.Module, axis: Optional[ModelAxis]) -> None:
    """Give every rank of the model group the gradients of the replicated
    parameters that its first rank computed (one broadcast per dtype).
    The ranks compute them alike, but not always bitwise so: cuDNN's
    convolution backward accumulates in a nondeterministic order, and
    replicas that drift apart by last bits drift further with each step.
    Nothing without an axis."""
    if axis is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in model.parameters():
        if p.grad is not None and getattr(p, "tp_spec", None) is None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    src = dist.get_global_rank(axis.group, 0)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.broadcast(flat, src=src, group=axis.group)
        for g, synced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(synced)


def squared_norm(tensors, sharded, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Σ‖t‖² over ``tensors`` that counts each parameter once: the squares
    of the tensors flagged in ``sharded`` are summed over the model group,
    the others (replicated) taken once."""
    rep = [t for t, s in zip(tensors, sharded) if not s]
    cut = [t for t, s in zip(tensors, sharded) if s]
    ref = (rep or cut)[0]
    total = sum(((t.float() ** 2).sum() for t in rep),
                torch.zeros((), device=ref.device))
    part = sum(((t.float() ** 2).sum() for t in cut),
               torch.zeros((), device=ref.device))
    if axis is not None and cut:
        part = reduce_out(part.clone(), axis)
    return total + part

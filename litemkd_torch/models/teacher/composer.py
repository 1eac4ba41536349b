"""The spec-driven fusion composer (port of
``litemkd_tpu/models/teacher/composer.py``): the reference's fusion
permutation zoo (``teacher/code/model.py:1394-2719, 3045-3122,
3462-3560``) as one module driven by branch specs,

    Branch(kind, idxs, shift=0, share=None, sides=(1, 1), depth=None)

    kind  := "pair"   2-stream concat encoder (TwoTransforFusion)
           | "multi"  N-stream concat encoder (Three/FourTransforTemproal;
                      ``depth`` overrides trans_num)
           | "cross"  BERT cross attention (transformer.py BertAttention)
           | "self"   per-stream plain encoder (ThreeFusion3's ``tran``)
           | "batch"  scalar-stat shift fusion (BatchTwoFusion)
    idxs  := modality indices (positions in ``modalities``; m1 first)
    shift := int — circular roll of the *last* stream along time, the same
             on both sides (positive = roll left) — or a per-side pair
             ``((mode, s), (mode, s))`` with mode "roll"|"pad"
             (zero-filled), support first
    share := branches with the same key share ONE module
    sides := which of (support, query) include this branch

Branch outputs are summed (``combine="sum"``) or folded through a cross
attention combiner (``combine="cross"``, ThreeCross); ``post="mlp"``
applies ThreeFusion3's bottleneck MLP; the head is the TCT stack
(``"trx"``), a single frame-level TCT (``"ctx"``, CTXBranch) or OTAM
(``"otam"``, no parameters).

A shared module is registered once, under one name, with each branch
holding its name: its keys are single and its gradient is the sum over its
uses, as in JAX. Each preset's modules take the reference class's
attribute names (:data:`PRESET_MODULES`), so a reference checkpoint loads;
a custom spec's take ``branch_modules_{i}``, i the first branch using it
(the JAX package's names).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...ops.otam import otam_logits
from ...ops.strm import BottleneckMLP2
from ...ops.tct import TemporalCrossTransformer
from .fusion import (BatchStatFusion, CrossAttentionFusion, MultiStreamFusion,
                     SelfEncoderBranch, TrxBranch, TwoStreamFusion, _roll_left,
                     _roll_right)

SideShift = Tuple[str, int]                     # ("roll"|"pad", frames)
ShiftSpec = Union[int, Tuple[SideShift, SideShift]]


class Branch(NamedTuple):
    kind: str
    idxs: Tuple[int, ...]
    shift: ShiftSpec = 0
    share: Optional[str] = None
    sides: Tuple[int, int] = (1, 1)
    depth: Optional[int] = None
    nhead: int = 0    # multi branches: 0 → per-arity default head count
    # bug-faithful released-encoder quirks (multi/self branches; see
    # fusion.Encoder.video_axis / MultiStreamFusion.shared_last_pe)
    video_axis: bool = False
    shared_last_pe: bool = False


BranchSpec = Union[Branch, Tuple]   # plain (kind, idxs, shift) tuples accepted

# named presets reproducing the reference fusion classes (modality indices
# refer to positions in cfg.model.modalities, m1 first; shift amounts bake the
# canonical shirt_num=1 of every released script). Pair/cross branches within
# one preset share a single fusion module exactly where the reference reuses
# one ``self.fusion`` for several calls. A copy of the JAX package's table.
PRESETS: Dict[str, Tuple[BranchSpec, ...]] = {
    # model.py:1394 TwoTRX — single pair fusion
    "TwoTRX": (Branch("pair", (0, 1)),),
    # model.py:1430 TwoCross — single BERT cross-attention fusion
    "TwoCross": (Branch("cross", (0, 1)),),
    # model.py:1462 ThreeCross — fusion1(m1,m2) and fusion1(m1,m3) (one shared
    # module) combined by a second cross attention (see PRESET_OPTIONS)
    "ThreeCross": (Branch("cross", (0, 1), share="f1"),
                   Branch("cross", (0, 2), share="f1")),
    # model.py:1499 TwoTRXShuffleTime — plain + shifted pair, one shared fusion
    "TwoTRXShuffleTime": (Branch("pair", (0, 1), 0, "f"),
                          Branch("pair", (0, 1), 1, "f")),
    # model.py:3083 TwoCTXShuffleTime — the same plain + shifted shared pair
    # fusion, classified by CTXBranch (a FRAME-level TCT, model.py:3045-3077)
    # instead of TrxBranch → head="ctx" (PRESET_OPTIONS)
    "TwoCTXShuffleTime": (Branch("pair", (0, 1), 0, "f"),
                          Branch("pair", (0, 1), 1, "f")),
    # as released (model.py:3101-3108): support rolled left by shirt_num; the
    # query side cat((first frames, rest)) == identity
    "TwoCTXShuffleTime_faithful": (
        Branch("pair", (0, 1), 0, "f"),
        Branch("pair", (0, 1), (("roll", 1), ("roll", 0)), "f")),
    # as released (model.py:1516-1523): support rolled left by shirt_num, but
    # the query side re-concatenates (prefix, rest) == identity
    "TwoTRXShuffleTime_faithful": (
        Branch("pair", (0, 1), 0, "f"),
        Branch("pair", (0, 1), (("roll", 1), ("roll", 0)), "f")),
    # model.py:1539 ThreeTRXShuffleTime — plain + shifted pairs per modality
    "ThreeTRXShuffleTime": (Branch("pair", (0, 1), 0, "f"),
                            Branch("pair", (0, 1), 1, "f"),
                            Branch("pair", (0, 2), 0, "f"),
                            Branch("pair", (0, 2), 1, "f")),
    # as released (model.py:1556-1566): exactly 3 branches; the shifts are
    # ZERO-PADDED (F.pad) with the amount hardcoded to 1 frame, m2 left and
    # m3 right, both sides; there is no unshifted third-modality branch
    "ThreeTRXShuffleTime_faithful": (
        Branch("pair", (0, 1), 0, "f"),
        Branch("pair", (0, 1), (("pad", 1), ("pad", 1)), "f"),
        Branch("pair", (0, 2), (("pad", -1), ("pad", -1)), "f")),
    # model.py:2262 ThreeStrm — despite the name, no STRM blocks: just the
    # 3-stream encoder (ThreeTransforTemproal) into the TRX branch
    "ThreeStrm": (Branch("multi", (0, 1, 2)),),
    # model.py:2335 FourStrm — FourTransforFusion: nhead=4, 2 layers fixed;
    # stream 4 gets its own PE and attention runs over time (the released
    # quirks are FourStrm_videoaxis)
    "FourStrm": (Branch("multi", (0, 1, 2, 3), depth=2, nhead=4),),
    # model.py:1588 ThreeTRXShiftLoopTime (MFM intent: m2 left, m3 right);
    # the released quirk version (identity third shift) is MFMTeacher
    "ThreeTRXShiftLoopTime": (Branch("multi", (0, 1, 2)),
                              Branch("pair", (0, 1), 1, "f"),
                              Branch("pair", (0, 2), -1, "f")),
    # model.py:2209 ThreeTRXLRShiftLoopTime — left and right shifts
    "ThreeTRXLRShiftLoopTime": (Branch("pair", (0, 1), 0, "f"),
                                Branch("pair", (0, 1), 1, "f"),
                                Branch("pair", (0, 2), -1, "f")),
    # as released (model.py:2224-2240): m2 support rolled left / query
    # identity; m3 support identity but m3 QUERY rolled left — the sides
    # shift in OPPOSITE corners
    "ThreeTRXLRShiftLoopTime_faithful": (
        Branch("pair", (0, 1), 0, "f"),
        Branch("pair", (0, 1), (("roll", 1), ("roll", 0)), "f"),
        Branch("pair", (0, 2), (("roll", 0), ("roll", 1)), "f")),
    # model.py:1712 / 1797 Four/FiveShiftFusion
    "FourShiftFusion": (Branch("multi", (0, 1, 2, 3)),
                        Branch("pair", (0, 1), 1, "f"),
                        Branch("pair", (0, 2), -1, "f"),
                        Branch("pair", (0, 3), 1, "f")),
    # as released (model.py:1731-1754): only m2 is genuinely rolled; the m3/m4
    # cat((suffix, rest)) degenerates to identity on both sides
    "FourShiftFusion_faithful": (
        Branch("multi", (0, 1, 2, 3)), Branch("pair", (0, 1), 1, "f"),
        Branch("pair", (0, 2), 0, "f"), Branch("pair", (0, 3), 0, "f")),
    # the released FiveShiftFusion's multi branch is the THREE-stream encoder
    # over (m1,m2,m3) only (model.py:1803, 1852), so both variants keep it
    "FiveShiftFusion": (Branch("multi", (0, 1, 2)),
                        Branch("pair", (0, 1), 1, "f"),
                        Branch("pair", (0, 2), -1, "f"),
                        Branch("pair", (0, 3), 1, "f"),
                        Branch("pair", (0, 4), -1, "f")),
    # as released (model.py:1818-1849): m2 and m5 rolled left, m3/m4 identity
    "FiveShiftFusion_faithful": (
        Branch("multi", (0, 1, 2)), Branch("pair", (0, 1), 1, "f"),
        Branch("pair", (0, 2), 0, "f"), Branch("pair", (0, 3), 0, "f"),
        Branch("pair", (0, 4), 1, "f")),
    # model.py:1990 TwoCombinationTRX — (m1,m2) + (m1,m3), one shared fusion
    "TwoCombinationTRX": (Branch("pair", (0, 1), 0, "f"),
                          Branch("pair", (0, 2), 0, "f")),
    # model.py:2022 TwoCombinationCTX — same but BERT cross attention
    "TwoCombinationCTX": (Branch("cross", (0, 1), 0, "f1"),
                          Branch("cross", (0, 2), 0, "f1")),
    # model.py:2054 ThreeCombinationTRX — 3 pairs vs m1, one shared fusion
    "ThreeCombinationTRX": (Branch("pair", (0, 1), 0, "f"),
                            Branch("pair", (0, 2), 0, "f"),
                            Branch("pair", (0, 3), 0, "f")),
    # model.py:3462 ThreeTRXCombination (the scripts' "combination_r+d+f"
    # model): MFM's branch set with NO time shift in the live forward
    # (model.py:3483-3489); its dump path left-rolls m2 and m3
    # (model.py:3513-3520) — see PRESET_EXTRACT
    "ThreeTRXCombination": (Branch("multi", (0, 1, 2)),
                            Branch("pair", (0, 1), 0, "f"),
                            Branch("pair", (0, 2), 0, "f")),
    # model.py:2096 TwoCombinationShiftTRX — shifted (m1,m2) + (m1,m3)
    "TwoCombinationShiftTRX": (Branch("pair", (0, 1), 1, "f"),
                               Branch("pair", (0, 2), -1, "f")),
    # as released (model.py:2112-2126): m2 rolled left both sides; m3
    # cat((suffix, rest)) == identity
    "TwoCombinationShiftTRX_faithful": (Branch("pair", (0, 1), 1, "f"),
                                        Branch("pair", (0, 2), 0, "f")),
    # model.py:2158 TwoCombinationTemTroShiftTRX — ThreeTransforTask (2-layer
    # 3-stream encoder) + the two shifted pairs
    "TwoCombinationTemTroShiftTRX": (
        Branch("multi", (0, 1, 2), depth=2),
        Branch("pair", (0, 1), 1, "f"), Branch("pair", (0, 2), -1, "f")),
    # as released (model.py:2192-2204): the 3-stream branch is added to the
    # SUPPORT fusion only; m2 rolled left both sides; m3 identity
    "TwoCombinationTemTroShiftTRX_faithful": (
        Branch("multi", (0, 1, 2), depth=2, sides=(1, 0)),
        Branch("pair", (0, 1), 1, "f"), Branch("pair", (0, 2), 0, "f")),
    # model.py:1896 OTAMThreeTRXShiftLoopTime — the MFM branch set as RELEASED
    # (m2 rolled left both sides, m3 identity, l.1918-1933) under a CNN_OTAM
    # head instead of the TRX branch
    "OTAMThreeTRXShiftLoopTime": (Branch("multi", (0, 1, 2)),
                                  Branch("pair", (0, 1), 1, "f"),
                                  Branch("pair", (0, 2), 0, "f")),
    # model.py:2555 ThreeFusion3 — self-encoded m1 + pair(m2, m3), MLP post
    "ThreeFusion3": (Branch("self", (0,), depth=3), Branch("pair", (1, 2))),
    # as released: the ``tran`` encoder omits batch_first → video-axis
    # attention (model.py:2566)
    "ThreeFusion3_videoaxis": (
        Branch("self", (0,), depth=3, video_axis=True),
        Branch("pair", (1, 2))),
    # as released: FourTransforFusion omits batch_first AND routes stream 4
    # through positionEncoding3 (PE4 constructed but dead, model.py:1218-1219)
    "FourStrm_videoaxis": (
        Branch("multi", (0, 1, 2, 3), depth=2, nhead=4, video_axis=True,
               shared_last_pe=True),),
    # model.py:2700 TwoFusionBatchFusion — scalar-stat shift fusion
    "TwoFusionBatchFusion": (Branch("batch", (0, 1)),),
}

# per-preset module-level options (combiner / post-processor / head)
PRESET_OPTIONS: Dict[str, Dict[str, str]] = {
    "ThreeCross": {"combine": "cross"},
    "OTAMThreeTRXShiftLoopTime": {"head": "otam"},
    "ThreeFusion3": {"post": "mlp"},
    "ThreeFusion3_videoaxis": {"post": "mlp"},
    "TwoCTXShuffleTime": {"head": "ctx"},
    "TwoCTXShuffleTime_faithful": {"head": "ctx"},
}

# per-preset EXTRACT-path branch specs, for reference classes whose per-video
# feature dump disagrees with their own live forward. Entries must match the
# live specs module-for-module — only shift/sides may differ.
PRESET_EXTRACT: Dict[str, Tuple[BranchSpec, ...]] = {
    # model.py:3506-3520: extract_feature left-rolls m2 AND m3 by shirt_num
    # before the shared pair fusion, unlike the unshifted live forward
    "ThreeTRXCombination": (Branch("multi", (0, 1, 2)),
                            Branch("pair", (0, 1), 1, "f"),
                            Branch("pair", (0, 2), 1, "f")),
}

# the reference attribute of each distinct branch module of a preset, in
# order of first use (the names of ``litemkd_tpu/tools/torch_import.py``'s
# ``_COMPOSED_IMPORTERS``); ``*_faithful`` and ``*_videoaxis`` presets take
# their base class's names. TwoCombinationCTX wraps a whole TwoCross as
# ``fusion1`` and uses its inner attention, ``fusion1.fusion``.
PRESET_MODULES: Dict[str, Tuple[str, ...]] = {
    "TwoTRX": ("fusion",),
    "TwoCross": ("fusion",),
    "ThreeCross": ("fusion1",),
    "TwoTRXShuffleTime": ("fusion",),
    "TwoCTXShuffleTime": ("fusion",),
    "ThreeTRXShuffleTime": ("fusion",),
    "ThreeStrm": ("three_fusion",),
    "FourStrm": ("fusion",),
    "ThreeTRXShiftLoopTime": ("three_fusion", "fusion"),
    "ThreeTRXLRShiftLoopTime": ("fusion",),
    "FourShiftFusion": ("four_fusion", "fusion"),
    "FiveShiftFusion": ("three_fusion", "fusion"),
    "TwoCombinationTRX": ("fusion",),
    "TwoCombinationCTX": ("fusion1.fusion",),
    "ThreeCombinationTRX": ("fusion",),
    "ThreeTRXCombination": ("three_fusion", "fusion"),
    "TwoCombinationShiftTRX": ("fusion",),
    "TwoCombinationTemTroShiftTRX": ("three_fusion", "fusion"),
    "OTAMThreeTRXShiftLoopTime": ("three_fusion", "fusion"),
    "ThreeFusion3": ("tran", "fusion"),
    "TwoFusionBatchFusion": ("fusion2",),
}


def preset_base(name: str) -> str:
    """The reference class of a preset: ``name`` without its ``_faithful``
    or ``_videoaxis`` suffix."""
    for suffix in ("_faithful", "_videoaxis"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _apply_side_shift(x: torch.Tensor, spec: SideShift) -> torch.Tensor:
    """Shift (..., T, D) along T: roll = circular, pad = zero-filled."""
    mode, s = spec
    if s == 0:
        return x
    if mode == "roll":
        return _roll_left(x, s) if s > 0 else _roll_right(x, -s)
    if s > 0:   # drop the first s frames, zero-pad the tail (F.pad (0,0,0,s))
        return torch.cat([x[..., s:, :], torch.zeros_like(x[..., :s, :])],
                         dim=-2)
    s = -s      # drop the last s frames, zero-pad the head (F.pad (0,0,s,0))
    return torch.cat([torch.zeros_like(x[..., :s, :]),
                      x[..., :x.shape[-2] - s, :]], dim=-2)


def _normalize_shift(shift: ShiftSpec) -> Tuple[SideShift, SideShift]:
    if isinstance(shift, int):
        return (("roll", shift), ("roll", shift))
    return shift


def _as_branch(spec: BranchSpec) -> Branch:
    return spec if isinstance(spec, Branch) else Branch(*spec)


def distinct_modules(branches: Sequence[BranchSpec]) -> Tuple[List[int], List[int]]:
    """(first, index): ``first[j]`` is the branch that first uses module j,
    ``index[i]`` the module of branch i (branches with one ``(kind,
    share)`` key share one module)."""
    first: List[int] = []
    index: List[int] = []
    keys: Dict[Tuple[str, str], int] = {}
    for i, spec in enumerate(branches):
        b = _as_branch(spec)
        key = (b.kind, b.share) if b.share else None
        if key is not None and key in keys:
            index.append(keys[key])
            continue
        if key is not None:
            keys[key] = len(first)
        index.append(len(first))
        first.append(i)
    return first, index


class CTXBranch(nn.Module):
    """CTXBranch (model.py:3045-3077): ONE frame-level TCT (tuples of a
    single frame) at ``transformers``, not a ModuleList."""

    def __init__(self, way: int, shot: int, seq_len: int, in_dim: int,
                 out_dim: int, dropout: float):
        super().__init__()
        self.transformers = TemporalCrossTransformer(
            way, shot, seq_len, in_dim=in_dim, out_dim=out_dim, set_size=1,
            dropout=dropout)

    def forward(self, support, support_labels, queries):
        return self.transformers(support, support_labels, queries)


class ComposedFusionTeacher(nn.Module):
    """Sum- or cross-combined branches over modality dicts, TRX, CTX or
    OTAM head, over a batch of episodes.

    ``forward(context_feats, context_labels, target_feats)``: the feats
    are dicts of (E, N, T, D) per modality → ``{'logits': (E, Q, way)}``;
    ``extract(feats, side)`` → fused (..., T, D) per video. The setup's
    checks and their ``ValueError``s are the JAX package's."""

    def __init__(self, way: int, shot: int, seq_len: int,
                 branches: Sequence[BranchSpec],
                 modalities: Sequence[str] = ("rgb", "depth", "flow"),
                 in_dim: int = 2048, out_dim: int = 1152, temp_set=(2,),
                 depth: int = 2, dropout: float = 0.1, head: str = "trx",
                 combine: str = "sum", post: Optional[str] = None,
                 extract_branches: Optional[Sequence[BranchSpec]] = None,
                 module_names: Optional[Sequence[str]] = None):
        super().__init__()
        self.way, self.shot = way, shot
        self.modalities = tuple(modalities)
        self.branches = tuple(_as_branch(s) for s in branches)
        self.head, self.combine, self.post = head, combine, post
        self.extract_branches = None
        branches = list(self.branches)
        if extract_branches is not None:
            ex = [_as_branch(s) for s in extract_branches]
            if len(ex) != len(branches) or any(
                    (a.kind, a.idxs, a.share, a.depth, a.nhead,
                     a.video_axis, a.shared_last_pe)
                    != (b.kind, b.idxs, b.share, b.depth, b.nhead,
                        b.video_axis, b.shared_last_pe)
                    for a, b in zip(ex, branches)):
                raise ValueError(
                    "extract_branches must match branches module-for-module "
                    "(only shift/sides may differ)")
            self.extract_branches = tuple(ex)
        for side in (0, 1):
            if not any(b.sides[side] for b in branches):
                raise ValueError(f"no branch active on side {side} "
                                 "(0=support, 1=query)")
        top = max(i for b in branches for i in b.idxs)
        if top >= len(self.modalities):
            raise ValueError(
                f"branch spec references modality index {top} but only "
                f"{len(self.modalities)} modalities are configured "
                f"({self.modalities}) — pass --modalities with at least "
                f"{top + 1} names for this fusion")
        seen: Dict[Tuple[str, str], Branch] = {}
        for b in branches:
            if not b.share:
                continue
            k = (b.kind, b.share)
            prev = seen.setdefault(k, b)
            if (len(prev.idxs) != len(b.idxs)
                    or (prev.depth or depth) != (b.depth or depth)
                    or prev.nhead != b.nhead
                    or prev.video_axis != b.video_axis
                    or prev.shared_last_pe != b.shared_last_pe):
                raise ValueError(
                    f"branches sharing {k} disagree on arity/depth/nhead/"
                    f"video_axis: {prev} vs {b}")
        first, index = distinct_modules(branches)
        if module_names is None:
            module_names = [f"branch_modules_{i}" for i in first]
        if len(module_names) != len(first):
            raise ValueError(f"{len(first)} distinct branch modules, "
                             f"{len(module_names)} names")
        for i, name in zip(first, module_names):
            b = branches[i]
            d = b.depth if b.depth is not None else depth
            if b.kind == "multi":
                m = MultiStreamFusion(len(b.idxs), seq_len, in_dim, d, dropout,
                                      nhead=b.nhead, video_axis=b.video_axis,
                                      shared_last_pe=b.shared_last_pe)
            elif b.kind == "cross":
                m = CrossAttentionFusion(in_dim, dropout=dropout)
            elif b.kind == "self":
                m = SelfEncoderBranch(in_dim, d, dropout,
                                      video_axis=b.video_axis)
            elif b.kind == "batch":
                m = BatchStatFusion(in_dim)
            else:
                m = TwoStreamFusion(seq_len, in_dim, d, dropout)
            self._register(name, m)
        self.branch_names = tuple(module_names[j] for j in index)
        if combine == "cross":
            self.fusion2 = CrossAttentionFusion(in_dim, dropout=dropout)
        if post == "mlp":
            self.MLP = BottleneckMLP2(in_dim)
        if head == "trx":
            self.bracnch = TrxBranch(way, shot, seq_len, in_dim, out_dim,
                                     temp_set, dropout)
        elif head == "ctx":
            self.bracnch = CTXBranch(way, shot, seq_len, in_dim, out_dim,
                                     dropout)
        elif head != "otam":
            raise ValueError(f"unknown head {head!r}; "
                             "choose trx | otam | ctx")

    def _register(self, dotted: str, module: nn.Module) -> None:
        parent: nn.Module = self
        *path, leaf = dotted.split(".")
        for part in path:
            if not hasattr(parent, part):
                parent.add_module(part, nn.Module())
            parent = getattr(parent, part)
        parent.add_module(leaf, module)

    def fuse(self, feats: Dict[str, torch.Tensor], side: int = 0,
             specs: Optional[Sequence[Branch]] = None) -> torch.Tensor:
        """``side``: 0 = support/context shift spec, 1 = query/target.
        ``specs`` swaps the branch specs (same modules) — the extract path."""
        streams = [feats[m] for m in self.modalities]
        outs = []
        for name, b in zip(self.branch_names, specs or self.branches):
            if not b.sides[side]:
                continue
            if (b.kind in ("multi", "self")
                    and any(s != 0 for _, s in _normalize_shift(b.shift))):
                # no reference fusion class shifts a multi/self stream
                raise ValueError(
                    f"shift is only defined for pair/cross/batch branches, "
                    f"got {b.kind!r} with shift={b.shift!r}")
            module = self.get_submodule(name)
            if b.kind == "multi":
                out = module(*(streams[i] for i in b.idxs))
            elif b.kind == "self":
                out = module(streams[b.idxs[0]])
            else:
                i, j = b.idxs
                out = module(streams[i], _apply_side_shift(
                    streams[j], _normalize_shift(b.shift)[side]))
            outs.append(out)
        if self.combine == "cross" and len(outs) > 1:
            fused = outs[0]
            for o in outs[1:]:
                fused = self.fusion2(fused, o)
        else:
            fused = sum(outs[1:], outs[0])
        if self.post == "mlp":
            fused = self.MLP(fused)
        return fused

    def forward(self, context_feats, context_labels, target_feats):
        fused_ctx = self.fuse(context_feats, side=0)
        fused_tgt = self.fuse(target_feats, side=1)
        if self.head == "otam":
            logits = otam_logits(fused_ctx, context_labels, fused_tgt,
                                 self.way, self.shot)
        else:
            logits = self.bracnch(fused_ctx, context_labels, fused_tgt)
        return {"logits": logits}

    def extract(self, feats: Dict[str, torch.Tensor],
                side: int = 0) -> torch.Tensor:
        """Fused features for the dump tools, on the support side (0) or,
        for the side-asymmetric ``*_faithful`` presets, the query side
        (1). Presets whose released dump disagrees with their live forward
        carry ``extract_branches`` (:data:`PRESET_EXTRACT`), used here
        only. Call it in eval mode."""
        return self.fuse(feats, side=side, specs=self.extract_branches)

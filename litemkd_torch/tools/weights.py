"""Carry JAX weights across into the reference torch key layout, and read
reference and torchvision ``.pt`` files into the port.

The port's own code for what ``litemkd_tpu/tools/torch_export.py:35-322``
and ``torch_import.py:32-44, 199-339, 407-630`` do: it takes the JAX
``{"params", "batch_stats"}`` tree as numpy arrays (no JAX needed) and
returns the state dict of a reference-layout student, which is also the
port's ``BatchedStudent`` layout:

- ``backbone.resnet.<seq>.…``: the trunk under the reference's
  ``nn.Sequential`` indices (0 conv1, 1 bn1, 4-7 layer1-layer4);
- ``backbone.fc1`` / ``backbone.fc2``, or the lone head of a 1-fc
  backbone (``backbone.res18_2048``, ``backbone.fc``), or none;
- ``classifier.transformers.{k_linear, v_linear, norm_k, norm_v, pe.pe}``.

An STRM student has the reference's CNN_STRM names under ``backbone.``
(``attn_pat``, ``lift``, ``fr_enrich``, ``fc1``/``fc2``) and
``classifier.distance.clsW``; a MobileNetV3 student torchvision's names
under ``backbone.mobile.0.`` and ``fc``/``fc1``/``fc2``; a skeleton
student the S3D encoder's (``backbone.t_embedding``, ``backbone.t_tr``);
a multi-set head its sets at ``classifier.transformers.{i}``; a CTX head
the compiled head's ``classifier.time_trans.*``. An ``ActionRecognitionNet`` goes to
``convnet.<seq>.…`` and ``fc``, a ``ViTClassifier`` to timm's names under
``convnet.`` and ``fc``.

Conversions: Dense kernel (in, out) → Linear weight (out, in); conv HWIO →
OIHW; BN scale/bias and mean/var → weight/bias and running stats
(``num_batches_tracked`` 0); the unused ``norm_v`` gets identity values and
``pe.pe`` the (1, int(1.5·seq_len), D) sinusoidal table; an MFM
encoder layer's q, k and v projections stack into the (3d, d)
``in_proj_weight`` of torch's ``nn.MultiheadAttention``, and a ViT
block's into timm's fused ``attn.qkv``.

Importers: a torchvision resnet or MobileNetV3 zoo file
(``conv1.weight``, ``layer1.0.conv1.weight``, …; ``features.N.*``), the
reference's pretrain artifact (``convnet.N.*``), its run.py expert
artifact (``resnet.N.*`` and ``transformers.{i}.*``; for an STRM backbone
its CNN_STRM artifact), its TRM artifact (``backbone.N.*``), its S3D
skeleton artifact (``encoder.*``) and teacher-half CTX artifact
(``time_trans.*``), a ``trunk.``-prefixed trunk, a full student
(``backbone.*``, ``classifier.*``) and a timm DeiT file become PARTIAL
state dicts, which :func:`merge_state_dict` lays over a fresh model's. A
file whose trunk has another depth or variant than the model's raises, as
does a key the model lacks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..models.backbones.mobilenet import MobileNetV3Backbone, SPECS
from ..models.backbones.resnet import FeatureBackbone, ResNetBackbone
from ..models.backbones.skeleton import SkeletonEncoder
from ..models.backbones.strm import STRMBackbone
from ..models.student import BACKBONES
from ..ops.positional import sinusoidal_pe

_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
_BLOCK_LAYERS = {18: ("1", "2"), 34: ("1", "2"), 50: ("1", "2", "3")}
_SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
        "layer4": "7"}
_TRUNK_HEADS = set(_SEQ) | set(_SEQ.values())


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = _np(p["kernel"]).T.copy()
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _conv(sd, key, p):
    sd[key] = np.transpose(_np(p["kernel"]), (3, 2, 0, 1)).copy()


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])
    sd[f"{prefix}.running_mean"] = _np(s["mean"])
    sd[f"{prefix}.running_var"] = _np(s["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _np(p["scale"])
    sd[f"{prefix}.bias"] = _np(p["bias"])


def _trunk(sd, params, stats, depth, prefix):
    _conv(sd, f"{prefix}{_SEQ['conv1']}.weight", params["conv1"])
    _bn(sd, f"{prefix}{_SEQ['bn1']}", params["bn1"], stats["bn1"])
    for i, n_blocks in enumerate(_STAGE_BLOCKS[depth]):
        for b in range(n_blocks):
            bp, bs = params[f"layer{i + 1}_{b}"], stats[f"layer{i + 1}_{b}"]
            dst = f"{prefix}{_SEQ[f'layer{i + 1}']}.{b}"
            for j in _BLOCK_LAYERS[depth]:
                _conv(sd, f"{dst}.conv{j}.weight", bp[f"conv{j}"])
            for j in _BLOCK_LAYERS[depth]:
                _bn(sd, f"{dst}.bn{j}", bp[f"bn{j}"], bs[f"bn{j}"])
            if "downsample_conv" in bp:
                _conv(sd, f"{dst}.downsample.0.weight", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # np.array copies: leaves may be read-only views of JAX buffers
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _check_depth(depth: int) -> None:
    if depth not in _STAGE_BLOCKS:
        raise ValueError(f"resnet depth {depth} is not ported (18, 34, 50)")


def backbone_state_dict_from_jax(params: dict, stats: dict, depth: int = 18,
                                 fc_names: Sequence[str] = ("fc1", "fc2")
                                 ) -> Dict[str, torch.Tensor]:
    """JAX ``ResNetBackbone`` params/batch_stats → ``ResNetBackbone`` keys
    (``resnet.<seq>.…`` and the heads): the JAX ``fc1`` and ``fc2`` go to
    ``fc_names`` in order (the port module's ``fc_names``)."""
    _check_depth(depth)
    sd: Dict[str, np.ndarray] = {}
    _trunk(sd, params["trunk"], stats["trunk"], depth, "resnet.")
    for src, dst in zip(("fc1", "fc2"), fc_names):
        _lin(sd, dst, params[src])
    return _tensors(sd)


def classifier_net_state_dict_from_jax(variables: dict,
                                       depth: Optional[int] = None
                                       ) -> Dict[str, torch.Tensor]:
    """JAX pretraining-classifier variables → the port's keys: an
    ``ActionRecognitionNet`` of ``depth`` to the reference's
    ``Action_Recognition_Resnet50`` keys (``convnet.<seq>.…``, ``fc``), a
    ``ViTClassifier`` (no ``depth``) to timm's names under ``convnet.``
    and ``fc``."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    if "cls_token" in params:
        _vit(sd, params, "convnet.")
    else:
        _check_depth(depth)
        _trunk(sd, params["trunk"], variables["batch_stats"]["trunk"], depth,
               "convnet.")
    _lin(sd, "fc", params["fc"])
    return _tensors(sd)


def _vit(sd, params, prefix):
    """JAX ``ViTClassifier`` trunk params → timm's names: flax MHA's
    per-projection (dim, heads, head_dim) kernels stack into the fused
    ``attn.qkv`` rows q; k; v."""
    for name in ("cls_token", "dist_token", "pos_embed"):
        sd[prefix + name] = _np(params[name])
    _conv(sd, f"{prefix}patch_embed.proj.weight", params["patch_embed"])
    sd[f"{prefix}patch_embed.proj.bias"] = _np(params["patch_embed"]["bias"])
    _ln(sd, f"{prefix}norm", params["norm"])
    i = 0
    while f"attn_{i}" in params:
        b, attn = f"{prefix}blocks.{i}", params[f"attn_{i}"]
        dim = _np(attn["query"]["kernel"]).shape[0]
        sd[f"{b}.attn.qkv.weight"] = np.concatenate(
            [_np(attn[n]["kernel"]).reshape(dim, dim).T
             for n in ("query", "key", "value")])
        sd[f"{b}.attn.qkv.bias"] = np.concatenate(
            [_np(attn[n]["bias"]).reshape(dim) for n in ("query", "key", "value")])
        sd[f"{b}.attn.proj.weight"] = \
            _np(attn["out"]["kernel"]).reshape(dim, dim).T.copy()
        sd[f"{b}.attn.proj.bias"] = _np(attn["out"]["bias"])
        _ln(sd, f"{b}.norm1", params[f"norm1_{i}"])
        _ln(sd, f"{b}.norm2", params[f"norm2_{i}"])
        _lin(sd, f"{b}.mlp.fc1", params[f"mlp_in_{i}"])
        _lin(sd, f"{b}.mlp.fc2", params[f"mlp_out_{i}"])
        i += 1


def tct_state_dict_from_jax(tct: dict, d_model: int, max_len: int
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``TemporalCrossTransformer`` params → its reference keys
    (``k_linear``, ``v_linear``, ``norm_k``, identity ``norm_v``, and the
    ``pe.pe`` table of ``max_len = int(1.5·seq_len)`` rows)."""
    sd: Dict[str, np.ndarray] = {}
    _lin(sd, "k_linear", tct["k_linear"])
    _lin(sd, "v_linear", tct["v_linear"])
    _ln(sd, "norm_k", tct["norm_k"])
    out_dim = _np(tct["norm_k"]["scale"]).shape[0]
    sd["norm_v.weight"] = np.ones((out_dim,), np.float32)
    sd["norm_v.bias"] = np.zeros((out_dim,), np.float32)
    sd["pe.pe"] = sinusoidal_pe(max_len, d_model, 0.1)[None]
    return _tensors(sd)


def _tct_sets(head: dict, cfg: Config) -> List[dict]:
    """A JAX head's TCT params, one per set in ``temp_set`` order: the flat
    TCT, or a ``MultiSetTCT``'s ``tct_{s}``."""
    t = head["transformers"]
    if "k_linear" in t:
        return [t]
    return [t[f"tct_{s}"] for s in cfg.model.temp_set]


def _encoder_params(sd, prefix, encoder):
    for name, layer in encoder.items():
        _encoder_layer(sd, f"{prefix}.layers.{name[len('layer'):]}", layer)


def classifier_state_dict_from_jax(head: dict, cfg: Config
                                   ) -> Dict[str, torch.Tensor]:
    """A JAX head's params → the port's head keys: the TCT at
    ``transformers.*`` (several sets at ``transformers.{i}.*`` in
    ``temp_set`` order), a CTX head's ``time_trans.*`` (``positionEncoding``,
    ``transformer_encoder.layers.{l}`` and, where the head has it, ``f1``),
    an STRM head's ``distance.clsW``. A parameter-free head (e_dist, cos,
    OTAM) gives none."""
    out: Dict[str, torch.Tensor] = {}
    if "transformers" in head:
        sets = _tct_sets(head, cfg)
        for i, tct in enumerate(sets):
            prefix = "transformers" if len(sets) == 1 else f"transformers.{i}"
            out.update({f"{prefix}.{k}": v for k, v in tct_state_dict_from_jax(
                tct, cfg.model.trans_linear_in_dim,
                int(1.5 * cfg.episode.seq_len)).items()})
    sd: Dict[str, np.ndarray] = {}
    if "time_trans" in head:
        tt = head["time_trans"]
        pe = tt["pe"]
        sd["time_trans.positionEncoding.position_embeddings.weight"] = \
            _np(pe["position_embeddings"])
        _ln(sd, "time_trans.positionEncoding.LayerNorm", pe["LayerNorm_0"])
        _encoder_params(sd, "time_trans.transformer_encoder", tt["encoder"])
        if "f1" in tt:
            _lin(sd, "time_trans.f1", tt["f1"])
    if "distance" in head:
        _lin(sd, "distance.clsW", head["distance"]["clsW"])
    out.update(_tensors(sd))
    return out


def _mobilenet_trunk(sd, params, stats, variant, prefix):
    """JAX ``MobileNetV3Trunk`` params/batch_stats → torchvision's
    ``features`` keys under ``prefix`` (``export_mobilenet_trunk``,
    ``litemkd_tpu/tools/torch_export.py:86-123``)."""
    _conv(sd, f"{prefix}0.0.weight", params["stem"])
    _bn(sd, f"{prefix}0.1", params["stem_bn"], stats["stem_bn"])
    in_ch = 16
    for i, (_, e, o, se, _hs, _s) in enumerate(SPECS[variant]):
        bp, bs = params[f"block{i}"], stats[f"block{i}"]
        base, j = f"{prefix}{i + 1}.block", 0
        if e != in_ch:
            _conv(sd, f"{base}.{j}.0.weight", bp["expand"])
            _bn(sd, f"{base}.{j}.1", bp["expand_bn"], bs["expand_bn"])
            j += 1
        _conv(sd, f"{base}.{j}.0.weight", bp["depthwise"])
        _bn(sd, f"{base}.{j}.1", bp["depthwise_bn"], bs["depthwise_bn"])
        j += 1
        if se:
            for name in ("fc1", "fc2"):     # Dense (in, out) → 1×1 conv
                p = bp["se"][name]
                sd[f"{base}.{j}.{name}.weight"] = \
                    _np(p["kernel"]).T[:, :, None, None].copy()
                sd[f"{base}.{j}.{name}.bias"] = _np(p["bias"])
            j += 1
        _conv(sd, f"{base}.{j}.0.weight", bp["project"])
        _bn(sd, f"{base}.{j}.1", bp["project_bn"], bs["project_bn"])
        in_ch = o
    head = f"{prefix}{len(SPECS[variant]) + 1}"
    _conv(sd, f"{head}.0.weight", params["head"])
    _bn(sd, f"{head}.1", params["head_bn"], stats["head_bn"])


def _skeleton_backbone(sd, params, out_dim, seq_len):
    """JAX ``SkeletonEncoder`` params → the S3D encoder's names, with the
    PE table of ``max(seq_len, 8)`` rows."""
    _lin(sd, "t_embedding.0", params["embed_in"])
    _ln(sd, "t_embedding.1", params["embed_ln"])
    _lin(sd, "t_embedding.3", params["embed_out"])
    _encoder_params(sd, "t_tr", params["encoder"])
    sd["pe.pe"] = sinusoidal_pe(max(seq_len, 8), out_dim, 0.1)[None]


def backbone_geometry(name: str) -> Tuple[int, Tuple[str, ...]]:
    """(trunk depth, head names) of the ``BACKBONES`` entry ``name``."""
    if name not in BACKBONES:
        raise ValueError(f"backbone {name!r} is not ported: the port has "
                         f"{sorted(BACKBONES)}")
    kw = BACKBONES[name].keywords
    n_fc = kw["num_fc"]
    if BACKBONES[name].func is STRMBackbone and n_fc == 1:
        n_fc = 0        # its one stream is the enriched frames, no head
    names = ((), (kw.get("fc_name", "fc1"),), ("fc1", "fc2"))[n_fc]
    return kw["depth"], names


def _strm_backbone(sd, params, seq_len):
    """The STRM blocks of a JAX ``STRMBackbone`` → CNN_STRM names, with the
    blocks' sinusoidal tables."""
    a = params["attn_pat"]
    width = _np(a["query_proj"]["kernel"]).shape[0]
    for src, dst in (("query_proj", "query_proj"), ("key_proj", "key_proj"),
                     ("value_proj", "value_conv")):
        _lin(sd, f"attn_pat.{dst}", a[src])
    sd["attn_pat.gamma"] = _np(a["gamma"])
    for n in ("inp_fc", "hid_fc", "out_fc"):
        _lin(sd, f"attn_pat.Bot_MLP.{n}", a["bot_mlp"][n])
    sd["attn_pat.pe.pe"] = sinusoidal_pe(24, width, 0.1)[None]
    _lin(sd, "lift", params["lift"])
    f = params["fr_enrich"]
    for src, dst in (("tok_mlp", "Tok_MLP"), ("bot_mlp", "Bot_MLP")):
        for n in ("inp_fc", "out_fc"):
            _lin(sd, f"fr_enrich.{dst}.{n}", f[src][n])
    out_dim = _np(params["lift"]["bias"]).shape[0]
    sd["fr_enrich.pe.pe"] = sinusoidal_pe(int(seq_len * 1.5), out_dim, 0.1)[None]


def student_state_dict_from_jax(variables: dict, cfg: Config
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``BatchedStudent``/``Student`` variables (numpy leaves) of any
    backbone and head of the registries → the reference-layout torch state
    dict, which is the port's."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    name = cfg.model.backbone
    func = BACKBONES[name].func
    bb = params.get("backbone", {})
    out: Dict[str, torch.Tensor] = {}
    sd: Dict[str, np.ndarray] = {}
    if func is MobileNetV3Backbone:
        _mobilenet_trunk(sd, bb["trunk"], stats["backbone"]["trunk"],
                         BACKBONES[name].keywords["variant"], "mobile.0.")
        two = BACKBONES[name].keywords["num_fc"] == 2
        for src, dst in (("fc1", "fc1"), ("fc2", "fc2")) if two else (("fc1", "fc"),):
            _lin(sd, dst, bb[src])
    elif func is SkeletonEncoder:
        _skeleton_backbone(sd, bb, cfg.model.trans_linear_in_dim,
                           cfg.episode.seq_len)
    elif func is not FeatureBackbone:
        depth, fc_names = backbone_geometry(name)
        out.update({f"backbone.{k}": v for k, v in backbone_state_dict_from_jax(
            bb, stats["backbone"], depth, fc_names).items()})
        if "attn_pat" in bb:
            _strm_backbone(sd, bb, cfg.episode.seq_len)
    out.update({f"backbone.{k}": v for k, v in _tensors(sd).items()})
    out.update({f"classifier.{k}": v for k, v in classifier_state_dict_from_jax(
        params.get("classifier", {}), cfg).items()})
    return out


def teacher_state_dict_from_jax(teacher_vars: dict, cfg: Config
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``Teacher``/``BatchedTeacher`` variables → the released teacher
    layout, the keys ``export_teacher_checkpoint`` writes: the head's TCT
    sets at ``bracnch.transformers.{i}.*`` in ``temp_set`` order; nothing
    for a parameter-free head (OTAM, e_dist, cos). That layout holds TCT
    sets only, so a CTX teacher raises (the JAX exporter drops its
    ``time_trans``)."""
    head = teacher_vars["params"].get("classifier", {})
    if "time_trans" in head:
        raise ValueError("the released teacher layout holds TCT sets only; "
                         "a CTX teacher's time_trans has no place in it")
    if "transformers" not in head:
        return {}
    out: Dict[str, torch.Tensor] = {}
    for i, tct in enumerate(_tct_sets(head, cfg)):
        out.update({f"bracnch.transformers.{i}.{k}": v for k, v in
                    tct_state_dict_from_jax(tct, cfg.model.trans_linear_in_dim,
                                            int(1.5 * cfg.episode.seq_len)).items()})
    return out


def _tct_prefix(sd: Dict[str, torch.Tensor]) -> Optional[str]:
    for k in sd:
        if k.endswith("k_linear.weight"):
            return k[: -len(".k_linear.weight")]
    return None


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference ``.pt`` file's weights and its ``iteration`` (0 where it
    has none): unwraps ``model_state_dict`` and drops DataParallel
    ``module.`` segments."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    iteration = 0
    if isinstance(raw, dict) and "model_state_dict" in raw:
        iteration = int(raw.get("iteration", 0))
        raw = raw["model_state_dict"]
    return ({".".join(seg for seg in k.split(".") if seg != "module"): v
             for k, v in raw.items()}, iteration)


def teacher_state_dict_from_reference(sd: Dict[str, torch.Tensor],
                                      teacher: torch.nn.Module
                                      ) -> Dict[str, torch.Tensor]:
    """A reference teacher state dict (any prefix ending in a TCT, such as
    ``bracnch.transformers.0``) → the state dict of the port's
    ``BatchedTeacher`` ``teacher``. A multi-set head takes set i from
    ``<prefix>.{i}`` (``bracnch.transformers.{i}``), and the file must
    hold every set. Keys the file lacks (the unused ``norm_v``, the
    ``pe.pe`` table) keep the module's values; a parameter-free head
    (OTAM, e_dist, cos) has nothing to load."""
    out = dict(teacher.state_dict())
    head = "classifier.transformers."
    if not any(k.startswith(head) for k in out):
        return out
    prefix = _tct_prefix(sd)
    if prefix is None:
        raise KeyError("no TRX k_linear weights in the teacher state dict")
    n_sets = sum(k.startswith(head) and k.endswith(".k_linear.weight") and
                 k.count(".") == 4 for k in out)
    if n_sets:      # a multi-set head: classifier.transformers.{i}.*
        base = prefix.rsplit(".", 1)[0]
        missing = [i for i in range(n_sets)
                   if f"{base}.{i}.k_linear.weight" not in sd]
        if missing:
            raise KeyError(f"the teacher state dict lacks TCT sets {missing} "
                           f"under {base!r}")
    for k in out:
        if not k.startswith(head):
            continue
        rest = k[len(head):]
        src = f"{base}.{rest}" if n_sets else f"{prefix}.{rest}"
        if src in sd:
            out[k] = sd[src]
    return out


def _encoder_layer(sd, prefix, p):
    sd[f"{prefix}.self_attn.in_proj_weight"] = np.concatenate(
        [_np(p[n]["kernel"]).T for n in ("attn_q", "attn_k", "attn_v")])
    sd[f"{prefix}.self_attn.in_proj_bias"] = np.concatenate(
        [_np(p[n]["bias"]) for n in ("attn_q", "attn_k", "attn_v")])
    _lin(sd, f"{prefix}.self_attn.out_proj", p["attn_out"])
    _lin(sd, f"{prefix}.linear1", p["mlp_in"])
    _lin(sd, f"{prefix}.linear2", p["mlp_out"])
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])


def _stream_fusion(sd, prefix, p):
    i = 1
    while f"pe{i}" in p:
        pe = p[f"pe{i}"]
        sd[f"{prefix}.positionEncoding{i}.position_embeddings.weight"] = \
            _np(pe["position_embeddings"])
        _ln(sd, f"{prefix}.positionEncoding{i}.LayerNorm", pe["LayerNorm_0"])
        i += 1
    _encoder_params(sd, f"{prefix}.transformer_encoder", p["encoder"])
    _lin(sd, f"{prefix}.f1", p["fuse_proj"])


def mfm_state_dict_from_jax(variables: dict, cfg: Config
                            ) -> Dict[str, torch.Tensor]:
    """JAX ``MFMTeacher`` variables (numpy leaves) → the reference
    ``ThreeTRXShiftLoopTime`` state dict, which is the port's
    ``MFMTeacher`` layout: ``three_fusion.*`` and ``fusion.*``
    (``positionEncoding{i}``, ``transformer_encoder.layers.{l}``, ``f1``)
    and ``bracnch.transformers.{i}.*``, one TCT per ``temp_set`` entry in
    ``temp_set`` order. Key for key what ``export_mfm_checkpoint`` writes."""
    params = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    _stream_fusion(sd, "three_fusion", params["three_fusion"])
    _stream_fusion(sd, "fusion", params["fusion"])
    out = _tensors(sd)
    t = params["branch"]["transformers"]
    for i, s in enumerate(cfg.model.temp_set):
        out.update({f"bracnch.transformers.{i}.{k}": v for k, v in
                    tct_state_dict_from_jax(
                        t[f"tct_{s}"], cfg.model.trans_linear_in_dim,
                        int(1.5 * cfg.episode.seq_len)).items()})
    return out


def load_reference_mfm_state_dict(path: str, cfg: Config
                                  ) -> Dict[str, torch.Tensor]:
    """A ``ThreeTRXShiftLoopTime`` ``.pt`` (the reference's, one that
    ``export_mfm_checkpoint`` wrote, or the port's own) as a state dict for
    the port's ``MFMTeacher``, after the geometry guards of the JAX
    package's ``load_mfm_checkpoint`` (``torch_import.py:299-339``): a file
    with more encoder layers than ``trans_num``, another number of frames
    than ``seq_len`` or more TCT sets than ``temp_set`` raises, instead of
    loading a truncated teacher."""
    sd = load_reference_checkpoint(path)[0]
    depth = cfg.model.trans_num
    for prefix in ("three_fusion", "fusion"):
        if (f"{prefix}.transformer_encoder.layers.{depth}."
                "self_attn.in_proj_weight") in sd:
            raise ValueError(
                f"{path}: {prefix} has more encoder layers than "
                f"trans_num={depth}; pass --trans_num matching the trained "
                "teacher")
        pe = sd[f"{prefix}.positionEncoding1.position_embeddings.weight"]
        if pe.shape[0] != cfg.episode.seq_len:
            raise ValueError(
                f"{path}: {prefix} positional table has {pe.shape[0]} frames "
                f"but seq_len={cfg.episode.seq_len}")
    n_sets = len(cfg.model.temp_set)
    if f"bracnch.transformers.{n_sets}.k_linear.weight" in sd:
        raise ValueError(
            f"{path}: checkpoint has more TCT sets than temp_set="
            f"{cfg.model.temp_set}; pass --temp_set matching the trained "
            "teacher")
    return sd


# ---------------------------------------------------------------------------
# The fusion zoo: TSF, DGA/DGA2, two-road and the composer presets
# ---------------------------------------------------------------------------

def _cross(sd, prefix, p):
    for n in ("query", "key", "value"):
        _lin(sd, f"{prefix}.self.{n}", p[n])
    _lin(sd, f"{prefix}.output.dense", p["out"])
    _ln(sd, f"{prefix}.output.LayerNorm", p["norm"])


def _mlp2(sd, prefix, p):
    _lin(sd, f"{prefix}.inp_fc", p["inp_fc"])
    _lin(sd, f"{prefix}.out_fc", p["out_fc"])


def _trainable_pe(sd, prefix, p):
    sd[f"{prefix}.position_embeddings.weight"] = _np(p["position_embeddings"])
    _ln(sd, f"{prefix}.LayerNorm", p["LayerNorm_0"])


def _heads(head: dict, cfg: Config, prefix: str, sets: bool = True
           ) -> Dict[str, torch.Tensor]:
    """A JAX ``TrxBranch``'s params → ``<prefix>.transformers.{i}.*`` in
    ``temp_set`` order, or with ``sets=False`` (the CTX head's one
    frame-level TCT, ``tct_1``) ``<prefix>.transformers.*``."""
    t = head["transformers"]
    pairs = ([(f"{prefix}.transformers.{i}", t[f"tct_{s}"])
              for i, s in enumerate(cfg.model.temp_set)] if sets
             else [(f"{prefix}.transformers", t["tct_1"])])
    out: Dict[str, torch.Tensor] = {}
    for dst, tct in pairs:
        out.update({f"{dst}.{k}": v for k, v in tct_state_dict_from_jax(
            tct, cfg.model.trans_linear_in_dim,
            int(1.5 * cfg.episode.seq_len)).items()})
    return out


def _composed_from_jax(params: dict, cfg: Config, name: str, otam: bool
                       ) -> Dict[str, torch.Tensor]:
    from ..models.teacher.composer import (PRESET_MODULES, PRESET_OPTIONS,
                                           PRESETS, distinct_modules,
                                           preset_base)
    branches = PRESETS[name]
    sd: Dict[str, np.ndarray] = {}
    first, _ = distinct_modules(branches)
    for i, dst in zip(first, PRESET_MODULES[preset_base(name)]):
        p = params[f"branch_modules_{i}"]
        kind = branches[i].kind
        if kind in ("pair", "multi"):
            _stream_fusion(sd, dst, p)
        elif kind == "cross":
            _cross(sd, dst, p)
        elif kind == "self":
            _encoder_params(sd, dst, p["encoder"])
        else:
            _lin(sd, f"{dst}.f1", p["f1"])
    opts = PRESET_OPTIONS.get(name, {})
    if opts.get("combine") == "cross":
        _cross(sd, "fusion2", params["combiner"])
    if opts.get("post") == "mlp":
        _mlp2(sd, "MLP", params["post_mlp"])
    out = _tensors(sd)
    if not otam and opts.get("head") != "otam":
        out.update(_heads(params["classifier"], cfg, "bracnch",
                          sets=opts.get("head") != "ctx"))
    return out


def fusion_state_dict_from_jax(variables: dict, cfg: Config, kind: str
                               ) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) of ``make_mfm(cfg, kind=kind)`` → the
    port's state dict for the same kind, which is the reference class's
    key layout: the inverse of the JAX package's ``_COMPOSED_IMPORTERS``
    and ``_tsf_import`` (``litemkd_tpu/tools/torch_import.py:702-826``),
    with the buffers the port keeps (each TCT's ``pe.pe`` table and
    identity ``norm_v``; ``mlp1.pe.pe`` of DGA2). ``mfm`` goes through
    :func:`mfm_state_dict_from_jax`."""
    from ..models.teacher.fusion import tsf_branch_name
    if kind == "mfm":
        return mfm_state_dict_from_jax(variables, cfg)
    params = variables["params"]
    if kind == "tsf":
        out: Dict[str, torch.Tensor] = {}
        for i, m in enumerate(cfg.model.modalities):
            out.update(_heads(params[f"branch_{m}"], cfg, tsf_branch_name(i)))
        return out
    sd: Dict[str, np.ndarray] = {}
    if kind in ("dga", "dga2"):
        _stream_fusion(sd, "fusion1", params["fusion1"])
        _lin(sd, "fusion2.affine_scale", params["fusion2"]["affine_scale"])
        _lin(sd, "fusion2.affine_bias", params["fusion2"]["affine_bias"])
        if kind == "dga2":
            e = params["mlp1"]
            sd["mlp1.pe.pe"] = sinusoidal_pe(int(1.5 * cfg.episode.seq_len),
                                             cfg.model.trans_linear_in_dim)[None]
            _mlp2(sd, "mlp1.Tok_MLP", e["tok_mlp"])
            _mlp2(sd, "mlp1.Bot_MLP", e["bot_mlp"])
    elif kind in ("two_road", "two_road_videoaxis"):
        for i in range(3):
            _trainable_pe(sd, f"fusion.positionEncoding{i + 1}",
                          params[f"pes_{i}"])
        _encoder_params(sd, "fusion.transformer_encoder", params["encoder"])
        _lin(sd, "fusion.f1", params["proj"])
        _lin(sd, "f1", params["road1"])
        _lin(sd, "f2", params["road2"])
        _mlp2(sd, "MLP1", params["mlp1"])
        _mlp2(sd, "MLP2", params["mlp2"])
    else:
        otam = kind.startswith("otam:")
        return _composed_from_jax(params, cfg, kind[5:] if otam else kind,
                                  otam)
    out = _tensors(sd)
    out.update(_heads(params["branch"], cfg, "bracnch"))
    return out


# keys of reference files that no module reads (the JAX package's importers
# skip them): TwoCombinationCTX's whole TwoCross ``fusion1`` carries a dead
# TCT head, and the released FourTransforFusion a dead positionEncoding4
_DEAD_KEYS = {"TwoCombinationCTX": ("fusion1.bracnch.",),
              "FourStrm_videoaxis": ("fusion.positionEncoding4.",)}


def load_reference_fusion_state_dict(path: str, cfg: Config, kind: str
                                     ) -> Dict[str, torch.Tensor]:
    """A reference fusion-teacher ``.pt`` of any ``--model`` class (or the
    port's own checkpoint of that kind) as a state dict for ``make_mfm(cfg,
    kind)``: the counterpart of the JAX package's
    ``load_composed_checkpoint`` (``torch_import.py:828-849``). ``kind``
    takes a preset, its ``*_faithful`` or ``*_videoaxis`` variant (the base
    class's file), ``otam:<preset>`` (the preset's fusion modules; a TCT
    head in the file is not read), a bespoke kind or ``mfm``
    (:func:`load_reference_mfm_state_dict`). A TSF file is 3-modality. The
    caller loads the result strictly."""
    from ..models.teacher.composer import PRESETS, preset_base
    otam = kind.startswith("otam:")
    name = kind[5:] if otam else kind
    base = name[: -len("_faithful")] if name.endswith("_faithful") else name
    if base == "mfm":
        return load_reference_mfm_state_dict(path, cfg)
    bespoke = ("tsf", "dga", "dga2", "two_road", "two_road_videoaxis")
    if base not in bespoke and name not in PRESETS:
        raise ValueError(f"no composed-checkpoint importer for kind {kind!r}; "
                         f"known: {sorted(set(bespoke) | set(PRESETS))}")
    if base == "tsf" and len(cfg.model.modalities) != 3:
        raise ValueError(
            "TSF checkpoints are 3-modality (m1_branch/skeleton_branch/"
            f"flow_branch, model.py:1154-1191) but cfg.model.modalities="
            f"{cfg.model.modalities!r} has {len(cfg.model.modalities)} "
            "entries — pass exactly three --modalities")
    sd = load_reference_checkpoint(path)[0]
    if name in PRESETS and preset_base(name) == "ThreeStrm":
        # the reference's feature-space ScoreFusion CLASS (model.py:1960-
        # 1989) is ThreeStrm with its encoder at ``fusion_temproal``
        sd = {("three_fusion." + k[len("fusion_temproal."):]
               if k.startswith("fusion_temproal.") else k): v
              for k, v in sd.items()}
    dead = _DEAD_KEYS.get(base, ()) + (("bracnch.",) if otam else ())
    return {k: v for k, v in sd.items() if not k.startswith(dead)}


# ---------------------------------------------------------------------------
# Partial imports: torchvision, pretrain and expert files
# ---------------------------------------------------------------------------

def merge_state_dict(template: Dict[str, torch.Tensor],
                     overrides: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``template`` (a fresh model's state dict) with the entries of a
    PARTIAL import laid over it (the JAX package's
    ``deep_merge_variables``, ``litemkd_tpu/utils/tree.py:7-40``). A key the
    template lacks, or a shape it does not have, raises: a drifted layout
    would otherwise leave the intended weights at their random init while
    the load reports success."""
    out = dict(template)
    for k, v in overrides.items():
        if k not in out:
            raise KeyError(
                f"warm-start key {k!r} does not exist in the model's state "
                f"dict (it has {sorted(out)[:8]}…) — the imported "
                "checkpoint's layout does not match this model")
        if tuple(v.shape) != tuple(out[k].shape):
            raise ValueError(f"warm-start key {k!r} has shape "
                             f"{tuple(v.shape)}, the model {tuple(out[k].shape)}")
        out[k] = v
    return out


def _seq_trunk(sd: Dict[str, torch.Tensor], prefix: str = ""
               ) -> Dict[str, torch.Tensor]:
    """The resnet trunk entries of ``sd`` under ``prefix``, keyed by the
    reference's ``nn.Sequential`` indices (torchvision's attribute names
    ``conv1``, ``bn1``, ``layerN`` are rewritten); heads and
    ``num_batches_tracked`` are left out, as the JAX importer leaves them."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix) or k.endswith("num_batches_tracked"):
            continue
        parts = k[len(prefix):].split(".")
        if parts[0] not in _TRUNK_HEADS:
            continue
        parts[0] = _SEQ.get(parts[0], parts[0])
        out[".".join(parts)] = v
    return out


def _trunk_depth(trunk: Dict[str, torch.Tensor]) -> int:
    """Depth of a sequence-keyed resnet trunk from its blocks: a bottleneck
    conv3 means 50, a third block in layer1 34, else 18."""
    if "4.0.conv3.weight" in trunk:
        return 50
    if "4.2.conv1.weight" in trunk:
        return 34
    return 18


def _is_torchvision_resnet(sd: Dict[str, torch.Tensor]) -> bool:
    """A raw torchvision resnet zoo state dict (no wrapper prefix)."""
    return "conv1.weight" in sd and "layer1.0.conv1.weight" in sd


def _trunk_import(sd: Dict[str, torch.Tensor], prefix: str, depth: int,
                  path: str, what: str) -> Dict[str, torch.Tensor]:
    trunk = _seq_trunk(sd, prefix)
    have = _trunk_depth(trunk)
    if have != depth:
        # resnet34 basic blocks fit shape for shape into resnet18, so a
        # depth mismatch would load wrong weights silently
        raise ValueError(f"{path} holds resnet{have} weights but {what} "
                         f"needs resnet{depth}")
    return trunk


_DEIT_BLOCK_KEYS = tuple(f"{m}.{w}" for m in (
    "norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
    for w in ("weight", "bias"))


def _deit_trunk(sd: Dict[str, torch.Tensor], prefix: str
                ) -> Dict[str, torch.Tensor]:
    """The keys of a timm DeiT trunk under ``prefix`` that the JAX
    package's ``import_deit_trunk`` reads (``torch_import.py:360-404``),
    under ``convnet.``: the tokens, the patch embedding, every block and the
    final norm; timm's ``head``/``head_dist`` are left out."""
    depth = 1 + max(int(k[len(prefix):].split(".")[1]) for k in sd
                    if k.startswith(f"{prefix}blocks."))
    keys = ["cls_token", "dist_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias", "norm.weight", "norm.bias"]
    keys += [f"blocks.{i}.{k}" for i in range(depth) for k in _DEIT_BLOCK_KEYS]
    return {f"convnet.{k}": sd[prefix + k] for k in keys}


def load_pretrain_init(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """Warm-start weights for the pretraining classifier of ``arch``
    (``litemkd_tpu/tools/torch_import.py:407-452``), as a PARTIAL state
    dict under ``convnet.`` (no classifier head). A resnet takes the trunk
    of a torchvision zoo file, of a ``trunk.``-prefixed file, of the
    reference's pretrain artifact (``convnet.``, also the port's own
    pretrain checkpoint) or of its run.py expert artifact (``resnet.``);
    deit_small the trunk of a timm ``deit_small_distilled_patch16_224``
    file or of a saved ``model_distillation`` (timm's names under
    ``convnet.``, the port's deit checkpoint)."""
    sd = load_reference_checkpoint(path)[0]
    if arch == "deit_small":
        if "cls_token" in sd:
            return _deit_trunk(sd, "")
        if "convnet.cls_token" in sd:
            return _deit_trunk(sd, "convnet.")
        raise ValueError(f"{path} is not a timm DeiT checkpoint")
    depth = int(arch.replace("resnet", ""))
    if _is_torchvision_resnet(sd):
        prefix = ""
    elif "features.0.0.weight" in sd:
        raise ValueError(f"{path} is a mobilenet zoo checkpoint; the "
                         f"pretraining stage warm-starts resnet/deit trunks "
                         f"only (--arch {arch})")
    else:
        prefix = next((p for p in ("trunk.", "convnet.", "resnet.")
                       if any(k.startswith(p) for k in sd)), None)
        if prefix is None:
            raise ValueError(f"{path} is not a resnet zoo / pretrain checkpoint")
    trunk = _trunk_import(sd, prefix, depth, path, f"--arch {arch}")
    return {f"convnet.{k}": v for k, v in trunk.items()}


_TCT_KEYS = ("k_linear.weight", "k_linear.bias", "v_linear.weight",
             "v_linear.bias", "norm_k.weight", "norm_k.bias")
_ENCODER_LAYER_KEYS = tuple(f"{m}.{w}" for m in (
    "self_attn.out_proj", "linear1", "linear2", "norm1", "norm2")
    for w in ("weight", "bias")) + ("self_attn.in_proj_weight",
                                    "self_attn.in_proj_bias")


def _tct_import(sd: Dict[str, torch.Tensor], prefix: str,
                dst: str = "classifier.transformers"
                ) -> Dict[str, torch.Tensor]:
    """The TCT weights the JAX importer reads (``k_linear``, ``v_linear``,
    ``norm_k``) from under ``prefix``, under ``dst``."""
    return {f"{dst}.{k}": sd[f"{prefix}.{k}"] for k in _TCT_KEYS}


def _tct_stack_import(sd: Dict[str, torch.Tensor], cfg: Config, path: str,
                      prefix: str = "transformers") -> Dict[str, torch.Tensor]:
    """A reference TCT ModuleList under ``prefix``
    (``litemkd_tpu/tools/torch_import.py:523-543``): one set goes to
    ``classifier.transformers``, several to ``classifier.transformers.{i}``
    (a multi-set head), and then there must be one per ``temp_set`` entry.
    Empty where the file holds no set."""
    n_sets = 0
    while f"{prefix}.{n_sets}.k_linear.weight" in sd:
        n_sets += 1
    if n_sets == 1:
        return _tct_import(sd, f"{prefix}.0")
    if n_sets and n_sets != len(cfg.model.temp_set):
        raise ValueError(f"{path} holds {n_sets} TCT sets but temp_set="
                         f"{cfg.model.temp_set}; pass --temp_set matching the "
                         "trained model")
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_sets):
        out.update(_tct_import(sd, f"{prefix}.{i}",
                               f"classifier.transformers.{i}"))
    return out


def _encoder_import(sd, src, dst) -> Dict[str, torch.Tensor]:
    """The layers ``src.layers.{l}`` of a torch ``TransformerEncoder``
    under ``dst``."""
    out: Dict[str, torch.Tensor] = {}
    n = 0
    while f"{src}.layers.{n}.linear1.weight" in sd:
        out.update({f"{dst}.layers.{n}.{k}": sd[f"{src}.layers.{n}.{k}"]
                    for k in _ENCODER_LAYER_KEYS})
        n += 1
    if n == 0:
        raise ValueError(f"no encoder layers under {src!r}")
    return out


def _resnet_depth(backbone: str, path: str, what: str) -> int:
    if BACKBONES[backbone].func not in (ResNetBackbone, STRMBackbone):
        raise ValueError(f"{path} is {what}, which cannot warm-start "
                         f"backbone {backbone!r}")
    return backbone_geometry(backbone)[0]


def _mobilenet_variant(trunk: Dict[str, torch.Tensor], prefix: str) -> str:
    """large (16 feature entries) or small, from a torchvision
    ``features`` layout under ``prefix``."""
    return "large" if f"{prefix}16.0.weight" in trunk else "small"


def _mobilenet_import(sd, prefix, backbone, path, what):
    """The MobileNetV3 trunk of ``sd`` under ``prefix`` (torchvision's
    ``features`` layout) as ``backbone.mobile.0.*``; a file of the other
    variant, or a backbone that is not a MobileNetV3, raises
    (``litemkd_tpu/tools/torch_import.py:496-505``)."""
    entry = BACKBONES[backbone]
    if entry.func is not MobileNetV3Backbone:
        raise ValueError(f"mobilenet {what} {path} cannot warm-start backbone "
                         f"{backbone!r}")
    have, want = _mobilenet_variant(sd, prefix), entry.keywords["variant"]
    if have != want:
        raise ValueError(f"{path} is mobilenet_v3_{have} but backbone "
                         f"{backbone!r} needs mobilenet_v3_{want}")
    return {f"backbone.mobile.0.{k[len(prefix):]}": v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def _expert_import(sd, cfg, path, prefix="resnet."):
    """A run.py expert artifact (``litemkd_tpu/tools/torch_import.py:546-562``;
    with ``prefix="backbone."`` a TRM artifact's GAP trunk): its trunk and
    its TCT sets (``transformers.{i}``)."""
    backbone = cfg.model.backbone
    depth = _resnet_depth(backbone, path, "a resnet expert artifact")
    out = {f"backbone.resnet.{k}": v for k, v in
           _trunk_import(sd, prefix, depth, path, f"backbone {backbone!r}").items()}
    out.update(_tct_stack_import(sd, cfg, path))
    return out


def _cnn_strm_import(sd, cfg, path):
    """A CNN_STRM expert artifact (``litemkd_tpu/tools/torch_import.py:
    854-899``): its trunk (``resnet.``), ``attn_pat`` (``value_conv``, the
    released name), ``fr_enrich`` and its TCT (``transformers.0``), with
    ``lift`` set to the identity (the reference's trunk width already is
    ``out_dim``). The released file has no ``distance.clsW`` (the
    reference keeps those heads in a plain Python list), so it keeps the
    model's init."""
    if "transformers.0.k_linear.weight" not in sd:
        raise ValueError(f"{path} holds no transformers.* TCT keys: not a "
                         "CNN_STRM expert artifact")
    out = _expert_import(sd, cfg, path)
    keys = [f"attn_pat.{m}.{w}" for m in (
        "query_proj", "key_proj", "value_conv", "Bot_MLP.inp_fc",
        "Bot_MLP.hid_fc", "Bot_MLP.out_fc") for w in ("weight", "bias")]
    keys += ["attn_pat.gamma"]
    keys += [f"fr_enrich.{m}.{w}" for m in (
        "Tok_MLP.inp_fc", "Tok_MLP.out_fc", "Bot_MLP.inp_fc", "Bot_MLP.out_fc")
        for w in ("weight", "bias")]
    out.update({f"backbone.{k}": sd[k] for k in keys})
    out_dim = cfg.model.trans_linear_in_dim
    out["backbone.lift.weight"] = torch.eye(out_dim)
    out["backbone.lift.bias"] = torch.zeros(out_dim)
    return out


def _teacher_ctx_import(sd, cfg, path):
    """The teacher-half CTX artifact (``litemkd_tpu/tools/torch_import.py:
    902-938``, ``model.py:2938-3014``): its resnet trunk (``resnet.``), the
    ``time_trans`` PE and encoder layers (its ``f1`` is dead there and is
    left out) and its frame-level TCT (``transformers.``), for the
    ``CTX_videoaxis`` head."""
    backbone = cfg.model.backbone
    depth = _resnet_depth(backbone, path, "a teacher CTX artifact")
    out = {f"backbone.resnet.{k}": v for k, v in
           _trunk_import(sd, "resnet.", depth, path, f"backbone {backbone!r}").items()}
    pe = "time_trans.positionEncoding"
    for k in ("position_embeddings.weight", "LayerNorm.weight", "LayerNorm.bias"):
        out[f"classifier.{pe}.{k}"] = sd[f"{pe}.{k}"]
    out.update(_encoder_import(sd, "time_trans.transformer_encoder",
                               "classifier.time_trans.transformer_encoder"))
    out.update(_tct_import(sd, "transformers"))
    return out


def _skeleton_import(sd, cfg, path):
    """An S3D skeleton expert artifact (``litemkd_tpu/tools/torch_import.py:
    941-963``): the encoder's ``t_embedding`` (0, 1, 3) and ``t_tr``
    layers under ``backbone.``, and its TCT sets."""
    tct = _tct_stack_import(sd, cfg, path)
    if not tct:
        raise ValueError(f"{path} holds no transformers.* TCT keys: not an "
                         "S3D skeleton expert artifact")
    out = {f"backbone.t_embedding.{i}.{w}": sd[f"encoder.t_embedding.{i}.{w}"]
           for i in (0, 1, 3) for w in ("weight", "bias")}
    out.update(_encoder_import(sd, "encoder.t_tr", "backbone.t_tr"))
    out.update(tct)
    return out


def load_student_checkpoint(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file as a (maybe PARTIAL) ``BatchedStudent`` state dict, by
    the routes of ``litemkd_tpu/tools/torch_import.py:565-630``: a
    torchvision resnet or MobileNetV3 zoo file (the trunk only, the
    reference's ``pretrained=True``), a teacher-half CTX artifact
    (``time_trans.*``), an S3D skeleton artifact (``encoder.*``), a run.py
    expert artifact (``resnet.N.*`` and ``transformers.{i}``; for an STRM
    backbone the CNN_STRM artifact), a TRM artifact (``backbone.N.*`` and
    ``transformers.{i}``), or a full reference student (``backbone.*``,
    ``classifier.*``, with DataParallel ``module.`` segments dropped). A
    trunk of another depth or MobileNetV3 variant than the configured
    backbone's raises."""
    sd = load_reference_checkpoint(path)[0]
    backbone = cfg.model.backbone
    if _is_torchvision_resnet(sd):
        depth = _resnet_depth(backbone, path, "a resnet zoo checkpoint")
        return {f"backbone.resnet.{k}": v for k, v in _trunk_import(
            sd, "", depth, path, f"backbone {backbone!r}").items()}
    if "features.0.0.weight" in sd and "features.1.block.0.0.weight" in sd:
        return _mobilenet_import(sd, "features.", backbone, path,
                                 "zoo checkpoint")
    if "time_trans.positionEncoding.position_embeddings.weight" in sd:
        return _teacher_ctx_import(sd, cfg, path)
    if "encoder.t_embedding.0.weight" in sd:
        return _skeleton_import(sd, cfg, path)
    if not any(k.startswith("backbone.") for k in sd):
        if any(k.startswith("resnet.") for k in sd):
            if BACKBONES[backbone].func is STRMBackbone:
                return _cnn_strm_import(sd, cfg, path)
            return _expert_import(sd, cfg, path)
        raise ValueError(f"{path} is not a student, expert or torchvision "
                         "zoo checkpoint")
    if "backbone.0.weight" in sd and "transformers.0.k_linear.weight" in sd:
        return _expert_import(sd, cfg, path, prefix="backbone.")
    func = BACKBONES[backbone].func
    if func is MobileNetV3Backbone:
        _mobilenet_import(sd, "backbone.mobile.0.", backbone, path,
                          "student checkpoint")
    elif func in (ResNetBackbone, STRMBackbone):
        _trunk_import(sd, "backbone.resnet.", backbone_geometry(backbone)[0],
                      path, f"backbone {backbone!r}")
    return sd


# ---------------------------------------------------------------------------
# Export: a port checkpoint's weights as the reference's student, teacher-head
# or MFM ``.pt`` (``litemkd_tpu/tools/torch_export.py``
# ``export_{student,teacher,mfm}_checkpoint``). The port's state dicts are
# already in the reference key layout, so exporting selects and renames keys.
# ---------------------------------------------------------------------------

def _strict_keys(sd: Dict[str, torch.Tensor], model: torch.nn.Module,
                 what: str) -> None:
    missing = set(model.state_dict()) - set(sd)
    unexpected = set(sd) - set(model.state_dict())
    if missing or unexpected:
        raise ValueError(f"not the state dict of {what}: missing "
                         f"{sorted(missing)[:4]}, unexpected "
                         f"{sorted(unexpected)[:4]}")


def student_export_state_dict(sd: Dict[str, torch.Tensor], cfg: Config
                              ) -> Dict[str, torch.Tensor]:
    """A student checkpoint's weights in ``export_student_checkpoint``'s
    layout (every key of ``cfg``'s ``BatchedStudent``, as it is); raises
    where ``sd`` is not that student's."""
    from ..models import BatchedStudent
    with torch.device("meta"):
        _strict_keys(sd, BatchedStudent(cfg), f"{cfg.model.backbone} + "
                     f"{cfg.model.classifier}")
    return dict(sd)


def teacher_export_state_dict(sd: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """The TCT sets of a student checkpoint's head as the released teacher
    layout, ``bracnch.transformers.{i}.*`` (``export_teacher_checkpoint``):
    a single-set head's ``classifier.transformers.*`` becomes set 0, a
    multi-set head's ``classifier.transformers.{i}.*`` keep their order."""
    head = "classifier.transformers."
    if f"{head}k_linear.weight" in sd:
        return {f"bracnch.transformers.0.{k[len(head):]}": v
                for k, v in sd.items() if k.startswith(head)}
    out = {f"bracnch.transformers.{k[len(head):]}": v
           for k, v in sd.items()
           if k.startswith(head) and k[len(head):].split(".")[0].isdigit()}
    if not out:
        raise ValueError("the checkpoint's head has no TCT "
                         "(classifier.transformers.*) to export as a teacher")
    return out


def mfm_export_state_dict(sd: Dict[str, torch.Tensor], cfg: Config
                          ) -> Dict[str, torch.Tensor]:
    """An MFM checkpoint's weights in ``export_mfm_checkpoint``'s
    ``ThreeTRXShiftLoopTime`` layout (every key of ``make_mfm(cfg)``, as it
    is); raises where ``sd`` is not that teacher's."""
    from ..train.teacher_steps import make_mfm
    with torch.device("meta"):
        _strict_keys(sd, make_mfm(cfg), "the MFM teacher (ThreeTRXShiftLoopTime)")
    return dict(sd)


def save_reference_checkpoint(sd: Dict[str, torch.Tensor], path: str,
                              iteration: int = 0) -> None:
    """Write ``{"iteration", "model_state_dict"}``, as the reference's
    ``torch.save`` and the JAX package's exporters do."""
    torch.save({"iteration": iteration,
                "model_state_dict": {k: v.detach().cpu() for k, v in sd.items()}},
               path)

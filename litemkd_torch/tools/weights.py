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

An ``ActionRecognitionNet`` goes to ``convnet.<seq>.…`` and ``fc``.

Conversions: Dense kernel (in, out) → Linear weight (out, in); conv HWIO →
OIHW; BN scale/bias and mean/var → weight/bias and running stats
(``num_batches_tracked`` 0); the unused ``norm_v`` gets identity values and
``pe.pe`` the (1, int(1.5·seq_len), D) sinusoidal table; an MFM
encoder layer's q, k and v projections stack into the (3d, d)
``in_proj_weight`` of torch's ``nn.MultiheadAttention``.

Importers: a torchvision resnet zoo file (``conv1.weight``,
``layer1.0.conv1.weight``, …), the reference's pretrain artifact
(``convnet.N.*``), its run.py expert artifact (``resnet.N.*`` and
``transformers.{i}.*``), a ``trunk.``-prefixed trunk and a full student
(``backbone.*``, ``classifier.*``) become PARTIAL state dicts, which
:func:`merge_state_dict` lays over a fresh model's. A file whose trunk has
another depth than the model's raises, as does a key the model lacks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
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


def classifier_net_state_dict_from_jax(variables: dict, depth: int
                                       ) -> Dict[str, torch.Tensor]:
    """JAX ``ActionRecognitionNet`` variables → the reference's
    ``Action_Recognition_Resnet50`` keys (``convnet.<seq>.…``, ``fc``)."""
    _check_depth(depth)
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, np.ndarray] = {}
    _trunk(sd, params["trunk"], stats["trunk"], depth, "convnet.")
    _lin(sd, "fc", params["fc"])
    return _tensors(sd)


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


def backbone_geometry(name: str) -> Tuple[int, Tuple[str, ...]]:
    """(trunk depth, head names) of the ``BACKBONES`` entry ``name``."""
    if name not in BACKBONES:
        raise ValueError(f"backbone {name!r} is not ported: the port has "
                         f"{sorted(BACKBONES)}")
    kw = BACKBONES[name].keywords
    names = ((), (kw.get("fc_name", "fc1"),), ("fc1", "fc2"))[kw["num_fc"]]
    return kw["depth"], names


def student_state_dict_from_jax(variables: dict, cfg: Config
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``BatchedStudent``/``Student`` variables (numpy leaves) of a
    resnet backbone with a single-TCT TRX head → reference-layout torch
    state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    depth, fc_names = backbone_geometry(cfg.model.backbone)
    tct = params["classifier"]["transformers"]
    if "k_linear" not in tct:
        raise ValueError("multi-set TCT heads are not ported")
    sd = {f"backbone.{k}": v for k, v in backbone_state_dict_from_jax(
        params["backbone"], stats["backbone"], depth, fc_names).items()}
    sd.update({f"classifier.transformers.{k}": v for k, v in
               tct_state_dict_from_jax(tct, cfg.model.trans_linear_in_dim,
                                       int(1.5 * cfg.episode.seq_len)).items()})
    return sd


def teacher_state_dict_from_jax(teacher_vars: dict, cfg: Config
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``Teacher``/``BatchedTeacher`` variables (a single-TCT head such
    as TRX_2fcsup_fixed) → the released teacher layout
    (``bracnch.transformers.0.*``, the keys ``export_teacher_checkpoint``
    writes)."""
    tct = teacher_vars["params"]["classifier"]["transformers"]
    if "k_linear" not in tct:
        raise ValueError("multi-set TCT teacher heads are not ported")
    return {f"bracnch.transformers.0.{k}": v for k, v in
            tct_state_dict_from_jax(tct, cfg.model.trans_linear_in_dim,
                                    int(1.5 * cfg.episode.seq_len)).items()}


def _tct_prefix(sd: Dict[str, torch.Tensor]) -> Optional[str]:
    for k in sd:
        if k.endswith("k_linear.weight"):
            return k[: -len(".k_linear.weight")]
    return None


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` file's weights: unwraps ``model_state_dict`` and
    drops DataParallel ``module.`` segments."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "model_state_dict" in raw:
        raw = raw["model_state_dict"]
    return {".".join(seg for seg in k.split(".") if seg != "module"): v
            for k, v in raw.items()}


def teacher_state_dict_from_reference(sd: Dict[str, torch.Tensor],
                                      teacher: torch.nn.Module
                                      ) -> Dict[str, torch.Tensor]:
    """A reference teacher state dict (any prefix ending in a TCT, such as
    ``bracnch.transformers.0``) → the state dict of the port's
    ``BatchedTeacher`` ``teacher``. Keys the file lacks (the unused
    ``norm_v``, the ``pe.pe`` table) keep the module's values."""
    prefix = _tct_prefix(sd)
    if prefix is None:
        raise KeyError("no TRX k_linear weights in the teacher state dict")
    out = dict(teacher.state_dict())
    for k in out:
        src = f"{prefix}.{k[len('classifier.transformers.'):]}"
        if k.startswith("classifier.transformers.") and src in sd:
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
    for name, layer in p["encoder"].items():
        _encoder_layer(sd, f"{prefix}.transformer_encoder.layers."
                       f"{name[len('layer'):]}", layer)
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
    sd = load_reference_state_dict(path)
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


def load_pretrain_init(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """Warm-start weights for an ``ActionRecognitionNet`` of ``arch``
    (``litemkd_tpu/tools/torch_import.py:407-452``): the trunk of a
    torchvision zoo file, of a ``trunk.``-prefixed file, of the reference's
    pretrain artifact (``convnet.``, also the port's own pretrain
    checkpoint) or of its run.py expert artifact (``resnet.``), as a
    PARTIAL state dict under ``convnet.`` (no classifier head)."""
    if arch == "deit_small":
        raise NotImplementedError(
            "deit_small (ViTClassifier, import_deit_trunk) is not ported yet "
            "(ROADMAP queue 5); the port pretrains resnet18/34/50")
    depth = int(arch.replace("resnet", ""))
    sd = load_reference_state_dict(path)
    if _is_torchvision_resnet(sd):
        prefix = ""
    elif "features.0.0.weight" in sd:
        raise ValueError(f"{path} is a mobilenet zoo checkpoint; the "
                         f"pretraining stage warm-starts resnet trunks only "
                         f"(--arch {arch})")
    else:
        prefix = next((p for p in ("trunk.", "convnet.", "resnet.")
                       if any(k.startswith(p) for k in sd)), None)
        if prefix is None:
            raise ValueError(f"{path} is not a resnet zoo / pretrain checkpoint")
    trunk = _trunk_import(sd, prefix, depth, path, f"--arch {arch}")
    return {f"convnet.{k}": v for k, v in trunk.items()}


def _tct_import(sd: Dict[str, torch.Tensor], prefix: str
                ) -> Dict[str, torch.Tensor]:
    """The TCT weights the JAX importer reads (``k_linear``, ``v_linear``,
    ``norm_k``) from under ``prefix``, as the port's
    ``classifier.transformers`` keys."""
    return {f"classifier.transformers.{k}": sd[f"{prefix}.{k}"]
            for k in ("k_linear.weight", "k_linear.bias", "v_linear.weight",
                      "v_linear.bias", "norm_k.weight", "norm_k.bias")}


def _expert_import(sd, depth, path, backbone):
    """A run.py expert artifact (``litemkd_tpu/tools/torch_import.py:546-562``):
    its trunk under ``resnet.`` and its one TCT (``transformers.0``)."""
    out = {f"backbone.resnet.{k}": v for k, v in
           _trunk_import(sd, "resnet.", depth, path, f"backbone {backbone!r}").items()}
    if "transformers.1.k_linear.weight" in sd:
        raise NotImplementedError(
            f"{path} holds several TCT sets; multi-set heads are not ported "
            "yet (ROADMAP queue 6)")
    if "transformers.0.k_linear.weight" in sd:
        out.update(_tct_import(sd, "transformers.0"))
    return out


def load_student_checkpoint(path: str, cfg: Config) -> Dict[str, torch.Tensor]:
    """A ``.pt`` file as a (maybe PARTIAL) ``BatchedStudent`` state dict, by
    the routes of ``litemkd_tpu/tools/torch_import.py:565-630`` that this
    port has: a torchvision resnet zoo file (the trunk only, the reference's
    ``pretrained=True``), a run.py expert artifact (``resnet.N.*`` and
    ``transformers.0``), or a full
    reference student (``backbone.*``, ``classifier.*``, with DataParallel
    ``module.`` segments dropped). A trunk of another depth than the
    configured backbone's raises; CTX, S3D and mobilenet artifacts are not
    ported yet."""
    sd = load_reference_state_dict(path)
    backbone = cfg.model.backbone
    depth, _ = backbone_geometry(backbone)
    if _is_torchvision_resnet(sd):
        return {f"backbone.resnet.{k}": v for k, v in _trunk_import(
            sd, "", depth, path, f"backbone {backbone!r}").items()}
    for key, kind in (("time_trans.positionEncoding.position_embeddings.weight",
                       "CTX"), ("encoder.t_embedding.0.weight", "S3D skeleton"),
                      ("features.0.0.weight", "mobilenet")):
        if key in sd:
            raise NotImplementedError(f"{path} is a {kind} artifact; its "
                                      "importer is not ported yet (ROADMAP "
                                      "queue 6)")
    if not any(k.startswith("backbone.") for k in sd):
        if any(k.startswith("resnet.") for k in sd):
            return _expert_import(sd, depth, path, backbone)
        raise ValueError(f"{path} is not a student, expert or torchvision "
                         "resnet checkpoint")
    _trunk_import(sd, "backbone.resnet.", depth, path, f"backbone {backbone!r}")
    return sd

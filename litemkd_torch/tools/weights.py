"""Carry JAX student and teacher weights across into the reference torch
key layout, and load a reference teacher into the port.

The port's own code for what ``litemkd_tpu/tools/torch_export.py:35-215,
308-322`` and ``torch_import.py:32-44, 199-217`` do: it takes the JAX
``{"params", "batch_stats"}`` tree as numpy arrays (no JAX needed) and
returns the state dict of a reference-layout student, which is also the
port's ``BatchedStudent`` layout:

- ``backbone.resnet.<seq>.…``: the trunk under the reference's
  ``nn.Sequential`` indices (0 conv1, 1 bn1, 4-7 layer1-layer4);
- ``backbone.fc1`` / ``backbone.fc2``;
- ``classifier.transformers.{k_linear, v_linear, norm_k, norm_v, pe.pe}``.

Conversions: Dense kernel (in, out) → Linear weight (out, in); conv HWIO →
OIHW; BN scale/bias and mean/var → weight/bias and running stats
(``num_batches_tracked`` 0); the unused ``norm_v`` gets identity values and
``pe.pe`` the (1, int(1.5·seq_len), D) sinusoidal table.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.positional import sinusoidal_pe

_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
_SEQ = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
        "layer4": "7"}


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
            for conv in ("conv1", "conv2"):
                _conv(sd, f"{dst}.{conv}.weight", bp[conv])
            for bn in ("bn1", "bn2"):
                _bn(sd, f"{dst}.{bn}", bp[bn], bs[bn])
            if "downsample_conv" in bp:
                _conv(sd, f"{dst}.downsample.0.weight", bp["downsample_conv"])
                _bn(sd, f"{dst}.downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # np.array copies: leaves may be read-only views of JAX buffers
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def backbone_state_dict_from_jax(params: dict, stats: dict, depth: int = 18
                                 ) -> Dict[str, torch.Tensor]:
    """JAX ``ResNetBackbone`` params/batch_stats (2fc) → ``ResNetBackbone``
    keys (``resnet.<seq>.…``, ``fc1``, ``fc2``)."""
    if depth not in _STAGE_BLOCKS:
        raise ValueError(f"resnet depth {depth} is not ported (18, 34)")
    sd: Dict[str, np.ndarray] = {}
    _trunk(sd, params["trunk"], stats["trunk"], depth, "resnet.")
    for fc in ("fc1", "fc2"):
        _lin(sd, fc, params[fc])
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


def student_state_dict_from_jax(variables: dict, cfg: Config
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``BatchedStudent``/``Student`` variables (numpy leaves) of a
    resnet18/34 2fc backbone with a single-TCT TRX head → reference-layout
    torch state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    backbone = cfg.model.backbone
    if not backbone.startswith(("resnet18", "resnet34")) or \
            "fc2" not in params["backbone"]:
        raise ValueError(f"backbone {backbone!r} is not ported: the port "
                         "has resnet18_2fc and resnet34_2fc")
    depth = 34 if backbone.startswith("resnet34") else 18
    tct = params["classifier"]["transformers"]
    if "k_linear" not in tct:
        raise ValueError("multi-set TCT heads are not ported")
    sd = {f"backbone.{k}": v for k, v in backbone_state_dict_from_jax(
        params["backbone"], stats["backbone"], depth).items()}
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

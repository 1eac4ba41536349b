"""AOT serving artifacts through ``torch.export`` (port of
``litemkd_tpu/tools/aot.py``, which ships StableHLO through ``jax.export``).

The episodic scorer (a student in eval mode plus the merge of its branch
logits) and the MFM teacher's fused-feature extractor are traced once with
``torch.export`` on the device that will serve them and saved, weights
inside, as one ``.litemkd`` file: the ``torch.export.save`` archive (a zip)
with ``manifest.json`` among its extra files. A serving host loads it with
:func:`load_serving_artifact`, which imports only the registrations of the
port's custom ops (``litemkd::tct_attention``, ``litemkd::bn_sums``,
``litemkd::bn_bwd_sums``) and no module of ``litemkd_torch.models`` or
``litemkd_torch.train``: the port's form of serving with no model code.
The TCT kernel stays one ``litemkd.tct_attention`` node of the graph, so an
artifact traced on the card launches the hand-written kernel there.

Tensors that the forward creates (index tables, positional encodings) are
baked in on the export device: export on the device that serves, and load
there. The artifact does not carry the TF32 setting, so the loader turns
TF32 off as the CLIs do.

Manifest: JAX's fields, with ``torch_version`` for ``jax_version``,
``platforms`` the export device's type, ``device`` the export device, and
``input_dtypes`` (support labels are int64 in the port, int32 in JAX).
"""
from __future__ import annotations

import functools
import importlib
import json
import time
from typing import Callable, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.dtypes import set_fp32_math
from ..utils.tracing import span

_MANIFEST_NAME = "manifest.json"
# the modules whose import registers the custom ops an artifact may call
OP_MODULES = ("litemkd_torch.ops.tct_attention", "litemkd_torch.ops.batch_norm")


class _Scorer(nn.Module):
    def __init__(self, student: nn.Module, merge: Callable):
        super().__init__()
        self.student = student
        self.merge = merge

    def forward(self, support_clips, support_labels, query_clips):
        with span("score"):
            out = self.student(support_clips, support_labels, query_clips)
            return self.merge(out["logits"])


class _Extractor(nn.Module):
    def __init__(self, teacher: nn.Module):
        super().__init__()
        self.teacher = teacher

    def forward(self, feats):
        return self.teacher.extract(feats)


def make_serving_fn(cfg: Config, student: nn.Module) -> nn.Module:
    """Episodic scorer in eval mode: ``(support_clips uint8 (E, S, T, H, W,
    3), support_labels (E, S), query_clips uint8 (E, Q, T, H, W, 3)) →
    merged logits (E, Q, way)``, around ``student`` (a ``BatchedStudent``
    of ``cfg``)."""
    from ..distill import merge_logits
    return _Scorer(student, functools.partial(merge_logits,
                                              cfg.distill.name)).eval()


def make_extract_fn(teacher: nn.Module) -> nn.Module:
    """Fused-feature extractor in eval mode: ``{modality: (N, T, D)} →
    (N, T, D)``, the ``extract`` of ``teacher`` (the MFM teacher)."""
    return _Extractor(teacher).eval()


def _export(fn: nn.Module, args, out_path: str, manifest: dict,
            device: torch.device) -> dict:
    """Trace, save and return the manifest, with ``seconds`` (of
    ``torch.export.export`` and of ``torch.export.save``) added after it
    was written."""
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(fn, args)
    # the archive would otherwise keep the example inputs: 36 MB of zero
    # clips in a full-width scorer
    program.example_inputs = None
    manifest.update(platforms=[device.type], device=str(device),
                    torch_version=torch.__version__)
    t1 = time.perf_counter()
    with open(out_path, "wb") as f:
        torch.export.save(program, f, extra_files={
            _MANIFEST_NAME: json.dumps(manifest, indent=1)})
    return dict(manifest, seconds={"export": t1 - t0,
                                   "save": time.perf_counter() - t1})


def export_serving_artifact(cfg: Config, model: nn.Module, out_path: str,
                            device=None, episodes: int = 1) -> dict:
    """Trace the scorer around ``model`` (a ``BatchedStudent``, moved to
    ``device``, default cuda) for ``episodes`` episodes a call and write the
    artifact to ``out_path``; returns its manifest."""
    device = torch.device(device or "cuda")
    ep = cfg.episode
    s, q = ep.n_support, ep.n_queries(False)
    shapes = {
        "support_clips": (episodes, s, ep.seq_len, ep.img_size, ep.img_size, 3),
        "support_labels": (episodes, s),
        "query_clips": (episodes, q, ep.seq_len, ep.img_size, ep.img_size, 3),
    }
    labels = torch.arange(ep.way, device=device).repeat(ep.shot)[:s]
    args = (torch.zeros(shapes["support_clips"], dtype=torch.uint8, device=device),
            labels.expand(episodes, s).contiguous(),
            torch.zeros(shapes["query_clips"], dtype=torch.uint8, device=device))
    manifest = {
        "format": 1, "kind": "scorer",
        "way": ep.way, "shot": ep.shot, "queries": q, "seq_len": ep.seq_len,
        "img_size": ep.img_size, "episodes": episodes,
        "backbone": cfg.model.backbone, "classifier": cfg.model.classifier,
        "loss": cfg.distill.name,
        "input_shapes": {k: list(v) for k, v in shapes.items()},
        "input_dtypes": {"support_clips": "uint8", "support_labels": "int64",
                         "query_clips": "uint8"},
    }
    return _export(make_serving_fn(cfg, model.to(device)), args, out_path,
                   manifest, device)


def export_extract_artifact(cfg: Config, model: nn.Module, out_path: str,
                            device=None, batch: int = 8) -> dict:
    """Trace the MFM extractor around ``model`` (moved to ``device``,
    default cuda) for batches of ``batch`` videos and write the artifact to
    ``out_path``; returns its manifest."""
    device = torch.device(device or "cuda")
    d, t = cfg.model.trans_linear_in_dim, cfg.episode.seq_len
    shapes = {m: (batch, t, d) for m in cfg.model.modalities}
    dtype = next(model.parameters()).dtype
    feats = {m: torch.zeros(sh, dtype=dtype, device=device)
             for m, sh in shapes.items()}
    manifest = {
        "format": 1, "kind": "extract_mfm",
        "modalities": list(cfg.model.modalities), "seq_len": t, "dim": d,
        "batch": batch, "trans_num": cfg.model.trans_num,
        "shirt_num": cfg.model.shirt_num,
        "input_shapes": {k: list(v) for k, v in shapes.items()},
        "input_dtypes": {m: str(dtype).replace("torch.", "") for m in shapes},
    }
    return _export(make_extract_fn(model.to(device)), (feats,), out_path,
                   manifest, device)


def load_program(path: str):
    """A ``.litemkd`` artifact's ``torch.export`` program and manifest,
    with only the op registrations imported."""
    for name in OP_MODULES:
        importlib.import_module(name)
    extra = {_MANIFEST_NAME: ""}
    with open(path, "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    return program, json.loads(extra[_MANIFEST_NAME])


def op_nodes(program, op: str = "litemkd.tct_attention") -> int:
    """Calls of ``op`` in an exported program's graphs (nested ones, such as
    an autocast region's, included)."""
    return sum(str(n.target).startswith(op)
               for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function")


def load_serving_artifact(path: str, device=None) -> Tuple[Callable, dict]:
    """Load a ``.litemkd`` artifact → (callable, manifest). The callable
    runs the saved program under ``torch.inference_mode`` on the device it
    was exported on (``device``, where given, must be of that type):
    - ``scorer``: ``(support_clips, support_labels, query_clips) → logits``;
    - ``extract_mfm``: ``({modality: (N, T, D)}) → (N, T, D)``.
    Only the op registrations are imported, no model code; TF32 is turned
    off in matrix products and convolutions."""
    set_fp32_math()
    program, manifest = load_program(path)
    exported_on = torch.device(manifest["device"])
    if device is not None and torch.device(device).type != exported_on.type:
        raise ValueError(f"{path} was exported on {exported_on}; it runs there "
                         f"(its baked-in constants live there), not on {device}")
    module = program.module()

    def call(*args):
        with torch.inference_mode():
            return module(*args)

    return call, manifest

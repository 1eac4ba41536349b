"""Model families, one module each, found by name: the ``family`` of a
configuration file names ``portbench/families/<family>.py``, under the
benchmark's root first and then beside this package (:func:`load`). A new
family is a new file; nothing here names one.

A family module holds what differs between families, and nothing else:

- ``HEAD``: the substring that marks the head's leaves (the rest is the body).
- ``episodes(cfg_file, seed, batch, lo, hi, device, train=True)``: episodes
  [lo, hi) of pool batch ``batch`` of a run of ``seed``, as one dict of
  tensors with a leading episode axis.
- ``learning_rate(cfg_file)``: the configured SGD rate.
- ``train_state(cfg, device)`` and ``train_step(cfg, dp=None)``: the
  program's train state and step (``cfg`` the program's Config).
- ``reference_steps(cfg_file, weights, batches, seed, prec, replicas,
  exchange, half_batch)``: the plain reference's steps, as
  :func:`portbench.reference.student.train_steps` returns them.
- ``flop_counts(cfg_file)``: the frozen FLOP counts of its ``flops`` key.

A family that serves adds ``REQUEST`` (the episode's keys that the scorer
takes, in order), ``scorer(cfg, device)`` (the program's module and
scoring call), ``serving_state(cfg_file, weights, seed, device)`` (buffers
laid alike on both sides) and ``reference_score(cfg_file, weights, state,
request, prec)``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench import data

STREAM = {"model": 1, "teacher": 2}


def load(cell):
    """The family module of ``cell``'s configuration."""
    from portbench import spec
    return spec.code(cell.root, "families", cell.config["family"])


def sizes(cfg_file: Dict) -> Dict:
    """The configuration's numbers, flattened over its sections."""
    out = {}
    for fields in cfg_file["sizes"].values():
        out.update(fields)
    return out


def shapes(modules: Dict[str, Optional[torch.nn.Module]]) -> Dict[str, List]:
    """(name, shape) of every parameter of each named module."""
    return {k: [(n, tuple(p.shape)) for n, p in m.named_parameters()]
            for k, m in modules.items() if m is not None}


def draw(shapes: Dict[str, List], seed: int, device) -> Dict[str, Dict]:
    """Weights for each named module ('model', 'teacher') from the seed."""
    return {k: data.draw_weights(s, seed, STREAM[k], device) for k, s in shapes.items()}

"""The system under test, ``litemkd_torch``, where every family meets it
alike: its configuration, its fp32 math setting, its episode batch, the
data-parallel rank and its counters. Each family module
(``portbench/families/<family>.py``) names its own train state, step and
scorer; those and this module are the only ones of the benchmark that
import the program, and the reference imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


def config(cfg_file: Dict[str, Any], seed: int):
    """The program's Config of a configuration file: its preset, the
    file's ``overrides`` (section → field → value) and the run's seed.
    Every number under ``sizes`` must be the Config's, so the file states
    the configuration as it is run."""
    from litemkd_torch import preset
    cfg = preset(cfg_file["preset"])
    for section, fields in cfg_file.get("overrides", {}).items():
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
        cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section), **fields)})
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=int(seed)))
    for section, fields in cfg_file["sizes"].items():
        for k, v in fields.items():
            got = getattr(getattr(cfg, section), k)
            if (list(got) if isinstance(got, tuple) else got) != v:
                raise ValueError(f"{cfg_file['name']}: {section}.{k} is {got} in the "
                                 f"program's preset, {v} in the configuration file")
    return cfg


def set_fp32_math() -> None:
    from litemkd_torch.ops.dtypes import set_fp32_math as f
    f()


def episode_batch(b: Dict[str, Any]):
    from litemkd_torch.train.steps import EpisodeBatch
    return EpisodeBatch(b["support_clips"] if "support_clips" in b else b["support_feats"],
                        b["support_labels"],
                        b["query_clips"] if "query_clips" in b else b["query_feats"],
                        b["query_labels"],
                        b.get("support_feats") if "support_clips" in b else None,
                        b.get("query_feats") if "support_clips" in b else None)


def data_parallel(rank: int, world: int, device):
    from litemkd_torch.parallel.multihost import DataParallel
    return DataParallel(rank, world, torch.device(device))


def tct_launches() -> int:
    from litemkd_torch.ops.tct_attention import tct_attention
    return tct_attention.launches


def step_loss(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return metrics["task_loss"]

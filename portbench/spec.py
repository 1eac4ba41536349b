"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root, one
file per configuration (its ``file``), one per traffic mix
(``portbench/traffic/<traffic>.json``), one per cell
(``portbench/workloads/<cell>.json``: the limits of its correctness check),
one driver per kind of traffic (``portbench/drivers/<kind>.py``), one
module per model family that a configuration names
(``portbench/families/<family>.py``) and one reader per per-layer metric
(``portbench/layer_metrics/<metric>.py``).

A later change adds a configuration, a family, a mix, a cell or a metric
by adding files and entries; nothing here names one. Code files are looked up under
the root first and then beside this module, so a root that holds only data
files uses the drivers and readers of this checkout.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]        # the configuration's file
    mix: Dict[str, Any]           # the traffic mix's file
    limits: Dict[str, float]      # the cell's file: check name → limit
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    root: Path = HERE.parent


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _read(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _read(root / conf["file"])
    mix = _read(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
    limits = _read(root / "portbench" / "workloads" / f"{name}.json")["limits"]
    return Cell(name=name, chips=int(entry["chips"]), config=config, mix=mix,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                root=root)


def code(root: Path, kind: str, name: str):
    """Import ``portbench/<kind>/<name>.py``, from ``root`` if it has one,
    else from this checkout (a driver or family of this checkout as
    ``portbench.<kind>.<name>``, so that processes it spawns can import it
    by name)."""
    for base in (Path(root) / "portbench", HERE):
        path = base / kind / f"{name}.py"
        if path.exists() and base.resolve() == HERE and kind in ("drivers", "families"):
            return importlib.import_module(f"portbench.{kind}.{name}")
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no portbench/{kind}/{name}.py under {root} or {HERE.parent}")


def layer_reader(root: Path, name: str):
    return code(root, "layer_metrics", name)


def driver(root: Path, kind: str):
    return code(root, "drivers", kind)


def check_limits(cell: Cell, readings: Dict[str, float]) -> Optional[str]:
    """None where every limit of the cell has a reading, else what is amiss."""
    missing = sorted(set(cell.limits) - set(readings))
    return f"no reading for {missing}" if missing else None

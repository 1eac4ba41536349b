"""BENCHMARK.json against the files it names and the benchmark's contract:
names, units and lengths, every cell's configuration, mix, limits and
readers, at most one cell in four on four cards, and the run length that
a full check of 24 cells can afford."""
import json
import math
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

from portbench import spec  # noqa: E402


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_length_fits_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_metric_keys_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e


def test_configurations_exist_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def test_every_configuration_names_a_family_module():
    hooks = ("HEAD", "episodes", "learning_rate", "train_state", "train_step",
             "reference_steps", "flop_counts")
    for c in BENCH["configs"]:
        fam = spec.code(ROOT, "families", json.loads((ROOT / c["file"]).read_text())["family"])
        assert all(hasattr(fam, h) for h in hooks), c["name"]


def test_cells_files_and_chips():
    cells = BENCH["workloads"]
    pairs = {(w["config"], w["traffic"]) for w in cells}
    assert len(pairs) == len(cells) and 1 <= len(cells) <= 24
    four = [w for w in cells if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in cells)
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        cell = spec.load_cell(ROOT, w["name"])
        assert spec.driver(ROOT, cell.mix["driver"]).run
        assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_readers_state_what_the_benchmark_says():
    for m in BENCH["per_layer"]:
        r = spec.layer_reader(ROOT, m["name"])
        assert (r.LAYER, r.UNIT, r.BETTER, r.MOVES) == (m["layer"], m["unit"],
                                                       m["better"], m["moves"])
        for cell in m.get("workloads", []):
            moved = spec.load_cell(ROOT, cell).end_to_end
            assert m["moves"] in {e["name"] for e in moved}


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_without_a_trace(name):
    cell = spec.load_cell(ROOT, (BENCH["per_layer"][0].get("workloads") or
                                 [BENCH["workloads"][0]["name"]])[0])
    ctx = {"cell": cell, "trace": None, "notes": [],
           "outcome": {"device": {"platform": "cpu"}, "units": 0, "window_s": 1.0}}
    assert spec.layer_reader(ROOT, name).read(ctx) is None


def test_frozen_flop_counts_are_finite_and_split_by_dtype():
    for c in BENCH["configs"]:
        flops = json.loads((ROOT / c["file"]).read_text())["flops"]
        for unit, by in flops.items():
            assert set(by) <= {"bf16", "fp32"}
            assert all(math.isfinite(v) and v > 0 for v in by.values())

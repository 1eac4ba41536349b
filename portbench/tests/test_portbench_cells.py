"""Whole runs of tiny cells on the CPU, through everything of a run but the
look for a card: a cell, a mix and a per-layer metric that exist only in a
temporary folder; sound runs that come out correct; the control (the
reference one precision step down) and each fault that a cell can have,
planted under the timed path, that come out not correct."""
import importlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, spec
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Steps the window ran (a metric that exists only in this folder)."""
LAYER = "train steps"
UNIT = "steps"
BETTER = "higher"
MOVES = "train_eps_per_s"


def read(ctx):
    return float(ctx["outcome"]["units"])
'''


def family(cell):
    """The family module of a tiny cell, as a run finds it."""
    return importlib.import_module(
        "portbench.families." + {"tiny": "student", "tiny_mfm": "mfm"}[cell.split(".")[0]])


def run(root, cell, seed=2**31 + 7, traced=False):
    return harness.run_cell(root, harness.Args(cell, seed, 0.5, traced, "cpu",
                                               time.perf_counter()))


def test_a_cell_mix_and_metric_defined_only_in_a_temporary_folder(tmp_path):
    extra = {"name": "steps.train", "unit": "steps", "better": "higher",
             "source": "host_clock", "layer": "train steps", "moves": "train_eps_per_s",
             "workloads": ["tiny.train"]}
    root = tiny.write(tmp_path, ("tiny.train",), [extra])
    (root / "portbench" / "layer_metrics").mkdir()
    (root / "portbench" / "layer_metrics" / "steps.train.py").write_text(READER)
    r = run(root, "tiny.train", traced=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["steps.train"]["value"] >= 1
    assert "breakdown" in r and list(r)[-3:] == ["checks", "_where", "_notes"]
    plain = run(root, "tiny.train")
    assert set(plain["metrics"]) == {"train_eps_per_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mfm.train", "tiny.serve"])
def test_sound_runs_are_correct(tmp_path, cell):
    r = run(tiny.write(tmp_path, (cell,)), cell)
    assert r["correct"], (r["checks"], r["attempted"], r["failed"], r["_notes"][:3])
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mfm.train"])
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tmp_path, monkeypatch, cell):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    assert not run(tiny.write(tmp_path, (cell,)), cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mfm.train"])
def test_half_the_batch_left_out_is_not_correct(tmp_path, monkeypatch, cell):
    fam = family(cell)
    real_step, real_sgd = fam.train_step, torch.optim.SGD.step

    def half(x):
        if isinstance(x, dict):
            return {k: half(v) for k, v in x.items()}
        return None if x is None else x[: x.shape[0] // 2]

    def make(cfg, dp=None):
        step = real_step(cfg, dp)
        return lambda state, batch: step(state, type(batch)(*(half(x) for x in batch)))

    def doubled(self, closure=None):      # the mean over the episodes kept
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(2.0)
        return real_sgd(self, closure)

    monkeypatch.setattr(fam, "train_step", make)
    monkeypatch.setattr(torch.optim.SGD, "step", doubled)
    assert not run(tiny.write(tmp_path, (cell,)), cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny_mfm.train"])
@pytest.mark.parametrize("fault", ["scale", "skip"])
def test_an_update_at_another_scale_or_a_skipped_step_is_not_correct(tmp_path, monkeypatch,
                                                                    cell, fault):
    real, calls = torch.optim.SGD.step, []

    def faulty(self, closure=None):
        calls.append(1)
        if fault == "skip":                       # the second step never applied
            return None if len(calls) == 2 else real(self, closure)
        for group in self.param_groups:
            group["lr"] *= 1.5
        try:
            return real(self, closure)
        finally:
            for group in self.param_groups:
                group["lr"] /= 1.5

    monkeypatch.setattr(torch.optim.SGD, "step", faulty)
    r = run(tiny.write(tmp_path, (cell,)), cell)
    assert not r["correct"]
    assert r["checks"]["update_gap"]["value"] == pytest.approx(
        0.5 if fault == "scale" else 1.0, rel=1e-3)


FAMILY = '''"""The MFM family under another name (a family that exists only in this
folder)."""
from pathlib import Path

from portbench.families.mfm import *  # noqa: F401,F403
from portbench.families import mfm


def train_state(cfg, device):
    (Path(__file__).parent / "used").touch()
    return mfm.train_state(cfg, device)
'''


def test_a_family_defined_only_in_a_temporary_folder(tmp_path):
    root = tiny.write(tmp_path, ("tiny_mfm.train",))
    conf = root / "portbench" / "configs" / "tiny_mfm.json"
    conf.write_text(conf.read_text().replace('"family": "mfm"', '"family": "fused_toy"'))
    fams = root / "portbench" / "families"
    fams.mkdir()
    (fams / "fused_toy.py").write_text(FAMILY)
    r = run(root, "tiny_mfm.train")
    assert r["correct"], r["checks"]
    assert (fams / "used").exists()


def test_an_answer_altered_where_it_is_produced_is_not_correct(tmp_path, monkeypatch):
    from litemkd_torch.tools import aot
    real = aot._Scorer.forward

    def swapped(self, *args):
        out = real(self, *args).clone()
        out[:, [0, 1]] = out[:, [1, 0]]
        return out

    monkeypatch.setattr(aot._Scorer, "forward", swapped)
    assert not run(tiny.write(tmp_path, ("tiny.serve",)), "tiny.serve")["correct"]


def test_the_control_reads_past_a_limit_the_program_keeps(tmp_path):
    root = tiny.write(tmp_path, ("tiny.train",))
    cell = spec.load_cell(root, "tiny.train")
    rows = calibrate._training(cell, [21, 22, 23], 3, torch.device("cpu"))
    for r in rows:
        assert all(r["program"][k][0] <= v for k, v in cell.limits.items())
        assert any(r["control"][k][0] > v for k, v in cell.limits.items())
        assert any(r["half_batch"][k][0] > v for k, v in cell.limits.items())


def test_the_serving_control_reads_past_the_limit(tmp_path):
    root = tiny.write(tmp_path, ("tiny.serve",))
    cell = spec.load_cell(root, "tiny.serve")
    for r in calibrate._serving(cell, [31, 32, 33], 3, [], 0.5, torch.device("cpu")):
        assert r["program"] <= cell.limits["logit_gap"] < min(r["control"], r["altered"])


SITE = '''import os
if os.environ.get("PORTBENCH_TEST_NO_EXCHANGE"):
    import litemkd_torch.train.steps as steps
    steps.all_reduce_grads = lambda model, dp: None
'''


@pytest.mark.parametrize("exchange", [True, False])
def test_data_parallel_ranks_and_the_exchange_left_out(tmp_path, monkeypatch, exchange):
    root = tiny.write(tmp_path / "root", ("tiny.train.dp2",))
    if not exchange:
        site = tmp_path / "site"
        site.mkdir()
        (site / "sitecustomize.py").write_text(SITE)
        monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
            [str(site), str(ROOT), os.environ.get("PYTHONPATH", "")]))
        monkeypatch.setenv("PORTBENCH_TEST_NO_EXCHANGE", "1")
        import litemkd_torch.train.steps as steps
        monkeypatch.setattr(steps, "all_reduce_grads", lambda model, dp: None)
    r = run(root, "tiny.train.dp2")
    assert r["correct"] is exchange, r["checks"]
    assert r["device"]["count"] == 2 and r["device"]["forbidden"] == []


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "student.train",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=where,
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=""))
        assert p.returncode != 0 and p.stdout.strip() == ""

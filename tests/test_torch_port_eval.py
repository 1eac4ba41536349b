"""The ported eval slice as a whole against the JAX package: synthetic
batches, per-episode accuracies and the CI of ``run_eval`` on the same
weights and seed; the config copy; and the port's independence from JAX
(a CLI run in a fresh interpreter, and a scan of every import)."""
import argparse
import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.models import BatchedStudent as JaxBatchedStudent
from litemkd_tpu.train import make_eval_step as jax_make_eval_step
from litemkd_tpu.train import run_eval as jax_run_eval
import litemkd_torch.config as torch_config
from litemkd_torch.cli import test as torch_cli
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.models import BatchedStudent
from litemkd_torch.tools.weights import student_state_dict_from_jax
from litemkd_torch.train import make_eval_step, run_eval

REPO = Path(__file__).resolve().parent.parent
PRESETS = ["student_fc2sup_dist", "student_plain", "mfm_teacher",
           "student_mobilenet", "expert_trx", "expert_strm", "expert_baseline",
           "expert_skeleton_trx", "tiny"]


def _cfg(make, noise):
    base = make("tiny")
    return base.replace(
        model=dataclasses.replace(base.model, compute_dtype="float32"),
        data=dataclasses.replace(base.data, synthetic_noise=noise))


@pytest.mark.parametrize("with_feats", [False, True])
def test_synthetic_batches_equal_jax(with_feats):
    jcfg, cfg = _cfg(jax_config.preset, 0.3), _cfg(torch_config.preset, 0.3)
    jsrc = JaxSource(jcfg, n_classes=16, seed=7, with_teacher_feats=with_feats)
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=7,
                                 with_teacher_feats=with_feats)
    for train in (True, False):
        want = jsrc.sample_batch(np.random.default_rng(11), 3, train=train)
        got = src.sample_batch(np.random.default_rng(11), 3, train=train)
        for field in want._fields:
            w, g = getattr(want, field), getattr(got, field)
            if w is None:
                assert g is None, field
            else:
                assert g.dtype == w.dtype, field
                np.testing.assert_array_equal(g, w, err_msg=field)


def test_run_eval_matches_jax():
    """Whole slice: JAX run_eval and the port's run_eval on the same tiny
    student, seed and synthetic source (10 tasks: an 8-episode chunk and a
    remainder of 2) give identical per-episode accuracies and the same CI."""
    noise, n_tasks, seed = 4.0, 10, 5
    jcfg, cfg = _cfg(jax_config.preset, noise), _cfg(torch_config.preset, noise)
    jsrc = JaxSource(jcfg, n_classes=16, seed=jcfg.train.seed, noise=noise,
                     with_teacher_feats=False)
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=cfg.train.seed,
                                 noise=noise, with_teacher_feats=False)
    one = jsrc.sample_batch(np.random.default_rng(0), 1, train=False)
    variables = JaxBatchedStudent(jcfg).init(
        jax.random.key(3), one.support_clips, one.support_labels,
        one.query_clips, train=False)

    jax_accs, torch_accs = [], []
    jstep = jax.jit(jax_make_eval_step(jcfg))
    tstep = make_eval_step(cfg)

    def jax_step(v, batch):
        out = jstep(v, batch)
        jax_accs.append(np.asarray(out))
        return out

    def torch_step(model, batch):
        out = tstep(model, batch)
        torch_accs.append(out.numpy())
        return out

    want = jax_run_eval(jcfg, variables, jsrc, n_tasks=n_tasks, seed=seed,
                        eval_step=jax_step)
    model = BatchedStudent(cfg)
    model.load_state_dict(student_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), cfg), strict=True)
    got = run_eval(cfg, model.eval(), src, n_tasks=n_tasks, seed=seed,
                   eval_step=torch_step, device=torch.device("cpu"))

    assert [a.shape[0] for a in torch_accs] == [8, 2]
    np.testing.assert_array_equal(np.concatenate(torch_accs),
                                  np.concatenate(jax_accs))
    # mid-curve accuracies, so the comparison can tell heads apart
    assert 0.0 < got["accuracy"] < 100.0
    assert got["n_tasks"] == want["n_tasks"] == n_tasks
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-9)


@pytest.mark.parametrize("name", PRESETS)
def test_config_presets_equal_jax(name):
    assert dataclasses.asdict(torch_config.preset(name)) == \
        dataclasses.asdict(jax_config.preset(name))


def test_config_json_round_trips_between_packages():
    cfg = jax_config.preset("student_fc2sup_dist")
    back = torch_config.Config.from_dict(json.loads(cfg.to_json()))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert jax_config.Config.__dataclass_fields__.keys() == \
        torch_config.Config.__dataclass_fields__.keys()


@pytest.mark.parametrize("argv", [
    ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
     "--num_test_tasks", "16", "--synthetic_noise", "1.0"],
    ["--preset", "tiny", "--way", "4", "--shot", "3",
     "--query_per_class_test", "2", "--seq_len", "6", "--img_size", "48",
     "--temp_set", "3", "--distill_name", "ce", "--trans_linear_in_dim", "32",
     "--trans_linear_out_dim", "16", "--model_backbone", "resnet34_2fc",
     "--model_classifier", "TRX"],
    ["-m", "{dir}/student.pt", "--num_test_tasks", "7"],
    ["--preset", "mfm_teacher", "--dataset", "hmdb", "--split", "1",
     "--traintestlist", "{dir}/splits"],
    ["--preset", "student_fc2sup_dist", "--dataset", "ucf"],
    ["--preset", "tiny", "--dataset", "hmdb", "--RGB_path", "{dir}/frames",
     "--teacher_path", "{dir}/fused", "--traintestlist", "{dir}/splits",
     "--num_workers", "7", "--fixed_episode_file", "{dir}/fixed.json",
     "--cross_view", "--view", "2", "--view_root", "{dir}/views"],
    ["-m", "{dir}/student.pt", "--rgb_path", "{dir}/frames", "--fixed_view",
     "Camera_1", "--num_workers", "0"],
])
def test_cli_config_equals_jax(argv, tmp_path):
    """The port's eval flags build the config that the JAX package's
    builders build from the same command line (the last case starts from
    the config.json recorded beside a checkpoint)."""
    saved = jax_config.preset("tiny").replace(
        data=dataclasses.replace(jax_config.preset("tiny").data,
                                 synthetic_noise=2.5))
    (tmp_path / "config.json").write_text(saved.to_json())
    argv = [a.format(dir=tmp_path) for a in argv]
    p = argparse.ArgumentParser()
    jax_common.add_common_args(p)
    jax_common.add_test_args(p)
    args = p.parse_args(argv)
    want = jax_common.build_config(
        args, base=jax_common.load_saved_config(args.test_model_path))
    _, got = torch_cli.parse(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cli_runs_on_cpu_without_jax():
    """A fresh interpreter (this one has JAX loaded) imports the port, runs
    the eval CLI on the CPU and ends with no JAX, flax or litemkd_tpu
    module loaded."""
    code = (
        "import json, sys\n"
        "import litemkd_torch\n"
        "from litemkd_torch.cli.test import main\n"
        "s = main(['--preset', 'tiny', '--device', 'cpu', "
        "'--num_test_tasks', '3'])\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'litemkd_tpu'))\n"
        "print(json.dumps({'bad': bad, 'n': s['n_tasks']}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-2].startswith("synthetic: ") and lines[-2].endswith(
        " over 3 tasks"), proc.stdout
    result = json.loads(lines[-1])
    assert result == {"bad": [], "n": 3}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((REPO / "litemkd_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py", REPO / "synthetic_e2e.py"]
    assert len(files) > 20
    scanned = {str(f.relative_to(REPO)) for f in files}
    assert {"litemkd_torch/native/__init__.py", "litemkd_torch/data/video.py",
            "litemkd_torch/data/episodes.py", "litemkd_torch/data/prefetch.py",
            "litemkd_torch/cli/gen_fixed_split.py"} <= scanned
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                             "litemkd_tpu"), (f, mod)


def test_entry_points_default_to_cuda():
    """No device given: cuda, or an error where CUDA is missing; never a
    silent CPU run."""
    from litemkd_torch.cli.common import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)

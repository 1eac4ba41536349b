"""The ported eval slice as a whole against the JAX package: synthetic
batches, per-episode accuracies and the CI of ``run_eval`` on the same
weights and seed; the config copy; the port's independence from JAX (a
CLI run in a fresh interpreter, and a scan of every import); and the eval
extras from a JPEG tree: the teacher-mode eval CLI, per-task logs and the
confusion analysis over them."""
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
from litemkd_torch.cli import common as torch_common
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
    ["--preset", "tiny", "--test_model", "teacher", "--per_task_log",
     "{dir}/tasks.jsonl", "--model_teacher", "test_teacher_TRX_2fcsup_fixed"],
    ["--preset", "tiny", "--pallas_tct", "--wandb"],
    ["--preset", "tiny", "--mesh_data", "2", "--mesh_model", "1"],
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
    targs, got = torch_cli.parse(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (targs.test_model, targs.per_task_log) == \
        (args.test_model, args.per_task_log)


def _parsed_cfg(cli, argv):
    import importlib
    out = importlib.import_module(f"litemkd_torch.cli.{cli}").parse(argv)
    return out[-1]


@pytest.mark.parametrize("cli,extra", [
    ("test", []), ("train", []), ("train_teacher", []), ("pretrain", []),
    ("extract", ["--mode_extract", "mfm", "--out", "x"]),
    ("export", ["--ckpt", "x.pt", "--out", "y.pt"])])
def test_clis_accept_pallas_tct_and_wandb(cli, extra):
    """Every CLI of the port parses the JAX package's ``--pallas_tct``
    (``model.use_pallas``, as ``litemkd_tpu/cli/common.py`` maps it) and
    ``--wandb``; without them ``use_pallas`` keeps the preset's value."""
    argv = ["--preset", "tiny", "--device", "cpu"] + extra
    assert _parsed_cfg(cli, argv + ["--pallas_tct", "--wandb"]).model.use_pallas
    assert not _parsed_cfg(cli, argv).model.use_pallas


def test_wandb_flag_without_the_package_gives_notice_and_trains(tmp_path,
                                                                monkeypatch,
                                                                capsys):
    """``cli.train --wandb`` where wandb cannot be imported prints the JAX
    package's notice on stderr and trains on; the logger keeps no sink."""
    from litemkd_torch.cli import train as train_cli
    from litemkd_torch.utils.logging import MetricsLogger
    monkeypatch.setitem(sys.modules, "wandb", None)   # `import wandb` fails
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        state, _ = train_cli.main(
            ["--preset", "tiny", "--dataset", "synthetic", "--device", "cpu",
             "--wandb", "--pallas_tct", "-c", str(tmp_path / "run")])
    finally:
        torch.set_num_threads(threads)
    err = capsys.readouterr().err
    assert "[metrics] wandb requested but not installed; skipping" in err
    assert state.episodes_seen > 0 and (tmp_path / "run" / "config.json").exists()
    assert MetricsLogger(use_wandb=True)._wandb is None


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
            "litemkd_torch/cli/gen_fixed_split.py", "litemkd_torch/cli/pretrain.py",
            "litemkd_torch/models/backbones/classifier_net.py",
            "litemkd_torch/ops/strm.py", "litemkd_torch/models/backbones/strm.py",
            "litemkd_torch/models/classifiers/strm.py",
            "litemkd_torch/models/classifiers/edist.py",
            "litemkd_torch/tools/confusion.py", "litemkd_torch/tools/aot.py",
            "litemkd_torch/cli/export.py", "litemkd_torch/cli/demo.py",
            "litemkd_torch/data/transforms.py",
            "litemkd_torch/tools/shrink_dataset.py",
            "litemkd_torch/tools/follow_pid.py",
            "litemkd_torch/tools/pipeline_bench.py",
            "litemkd_torch/utils/tracing.py", "litemkd_torch/cli/flops.py",
            "litemkd_torch/cli/profile.py", "litemkd_torch/utils/saliency.py",
            "litemkd_torch/tools/figures.py", "litemkd_torch/cli/figures.py",
            "litemkd_torch/ops/pooling.py", "litemkd_torch/parallel/mesh.py",
            "litemkd_torch/parallel/multihost.py",
            "litemkd_torch/parallel/data_parallel.py"} <= scanned
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


# ---------------------------------------------------------------------------
# The eval extras: teacher mode, per-task logs, confusion analysis
# ---------------------------------------------------------------------------

EX_T, EX_D, EX_CLASSES, EX_VIDS, EX_TRAIN = 4, 64, 4, 6, 3


@pytest.fixture(scope="module")
def extras_dir(tmp_path_factory):
    """A JPEG frame tree (4 classes × 6 videos of 4 random 40×48 frames;
    3 test videos a class), the fused feature tree over the same videos,
    and the split lists."""
    from PIL import Image
    root = tmp_path_factory.mktemp("eval_extras")
    rng = np.random.default_rng(21)
    lines = ([], [])
    for c in range(EX_CLASSES):
        for v in range(EX_VIDS):
            name = f"class{c}/vid_{c}_{v}"
            (root / "rgb" / name).mkdir(parents=True)
            for f in range(EX_T):
                Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                    root / "rgb" / name / f"{f:05d}.jpg")
            (root / "fused" / name).mkdir(parents=True)
            np.save(root / "fused" / name / "feature.npy",
                    rng.normal(size=(EX_T, EX_D)).astype(np.float32))
            lines[v >= EX_TRAIN].append(name)
    (root / "splits").mkdir()
    for name, ls in zip(("trainlist03.txt", "testlist03.txt"), lines):
        (root / "splits" / name).write_text("\n".join(ls) + "\n")
    return root


def _extras_argv(root, *extra):
    return ["--preset", "tiny", "--dataset", "hmdb", "--rgb_path",
            str(root / "rgb"), "--teacher_path", str(root / "fused"),
            "--traintestlist", str(root / "splits"), "--num_test_tasks", "10",
            "--num_workers", "0", *extra]


def _fp32_presets(monkeypatch):
    for common, config in ((jax_common, jax_config),
                           (torch_common, torch_config)):
        monkeypatch.setattr(common, "preset",
                            lambda name, c=config: _cfg(c.preset, 0.3))


def test_teacher_eval_cli_matches_jax(extras_dir, tmp_path, monkeypatch):
    """``cli.test --test_model teacher`` in both packages from the same
    JAX-exported teacher ``.pt`` (``bracnch.transformers.0``): the teacher
    head's 'kl' logits on the fused features of 10 test episodes (a chunk
    of 8 and a remainder of 2) give the same accuracy and CI (abs 1e-9).
    Without ``-m`` the port's teacher gets seeded weights; a checkpoint
    directory is refused."""
    from litemkd_tpu.models import BatchedTeacher as JaxBatchedTeacher
    from litemkd_tpu.cli import test as jax_test_cli
    from litemkd_tpu.tools.torch_export import export_teacher_checkpoint
    _fp32_presets(monkeypatch)
    jcfg = _cfg(jax_config.preset, 0.3)
    feats = np.zeros((1, 6, EX_T, EX_D), np.float32)
    t_vars = jax.tree_util.tree_map(np.asarray, JaxBatchedTeacher(jcfg).init(
        jax.random.key(4), feats, np.zeros((1, 6), np.int32), feats,
        train=False))
    path = str(tmp_path / "teacher.pt")
    export_teacher_checkpoint(t_vars, jcfg, path)
    argv = _extras_argv(extras_dir, "--test_model", "teacher")
    want = jax_test_cli.main(argv + ["-m", path])
    got = torch_cli.main(argv + ["-m", path, "--device", "cpu"])
    assert got["n_tasks"] == want["n_tasks"] == 10
    assert 0.0 < got["accuracy"] < 100.0
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-9)
    seeded = torch_cli.main(argv + ["--device", "cpu"])
    assert seeded["n_tasks"] == 10
    with pytest.raises(ValueError, match="directory"):
        torch_cli.main(argv + ["-m", str(tmp_path), "--device", "cpu"])


@pytest.fixture(scope="module")
def task_logs(extras_dir, tmp_path_factory):
    """Both packages' ``cli.test --per_task_log`` over 10 test episodes of
    the frame tree, from the same JAX-exported student ``.pt``: (port
    records, JAX records, port summary, log directory)."""
    from litemkd_tpu.cli import test as jax_test_cli
    from litemkd_tpu.tools.torch_export import export_student_checkpoint
    from litemkd_tpu.tools.confusion import read_task_log as jax_read
    out = tmp_path_factory.mktemp("task_logs")
    with pytest.MonkeyPatch.context() as mp:
        _fp32_presets(mp)
        jcfg = _cfg(jax_config.preset, 0.3)
        clips = np.zeros((1, 6, EX_T, 32, 32, 3), np.uint8)
        variables = jax.tree_util.tree_map(np.asarray, JaxBatchedStudent(
            jcfg).init(jax.random.key(5), clips, np.zeros((1, 6), np.int32),
                       clips, train=False))
        path = str(out / "student.pt")
        export_student_checkpoint(variables, jcfg, path)
        argv = _extras_argv(extras_dir, "-m", path)
        jax_test_cli.main(argv + ["--per_task_log", str(out / "jax.jsonl")])
        summary = torch_cli.main(argv + ["--per_task_log",
                                         str(out / "port.jsonl"),
                                         "--device", "cpu"])
    from litemkd_torch.tools.confusion import read_task_log
    return (read_task_log(str(out / "port.jsonl")),
            jax_read(str(out / "jax.jsonl")), summary, out)


def test_per_task_log_matches_jax(task_logs):
    """One record per task in task order, across the chunk of 8 and the
    remainder of 2 (the one-chunk-delayed host read keeps the order):
    ``classes``, ``real_labels`` and ``real_preds`` equal to the JAX
    package's, ``accuracy`` at abs 1e-9; the records' mean accuracy is the
    summary's."""
    got, want, summary, _ = task_logs
    assert [r["task"] for r in got] == list(range(10))
    assert len(want) == 10
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"task", "accuracy", "classes",
                                        "real_labels", "real_preds"}
        for k in ("task", "classes", "real_labels", "real_preds"):
            assert g[k] == w[k], k
        assert g["accuracy"] == pytest.approx(w["accuracy"], abs=1e-9)
        assert len(g["classes"]) == 3 and len(g["real_preds"]) == 3
        assert set(g["real_preds"]) <= set(g["classes"])
    mean = 100.0 * np.mean([r["accuracy"] for r in got])
    assert mean == pytest.approx(summary["accuracy"], abs=1e-9)


def test_confusion_tools_match_jax(task_logs):
    """``tools/confusion`` on the port's records against the JAX package's
    tool: the matrix, the class ids, per-class accuracy, the most-confused
    pairs and the CSV text; every query is counted once, and the diagonal
    sums to the correct predictions. ``render_png`` writes a figure."""
    from litemkd_tpu.tools import confusion as jconf
    from litemkd_torch.tools import confusion as tconf
    records, _, _, out = task_logs
    m, ids = tconf.confusion_from_records(records)
    jm, jids = jconf.confusion_from_records(records)
    assert ids == jids and m.dtype == np.int64
    np.testing.assert_array_equal(m, jm)
    assert m.sum() == sum(len(r["real_labels"]) for r in records)
    assert np.trace(m) == sum(t == p for r in records
                              for t, p in zip(r["real_labels"], r["real_preds"]))
    np.testing.assert_array_equal(tconf.per_class_accuracy(m),
                                  jconf.per_class_accuracy(jm))
    assert tconf.most_confused(m, ids, top=5) == jconf.most_confused(jm, jids, top=5)
    names = {c: f"class{c}" for c in ids}
    tconf.write_csv(m, ids, str(out / "port.csv"), names)
    jconf.write_csv(jm, jids, str(out / "jax.csv"), names)
    assert (out / "port.csv").read_text() == (out / "jax.csv").read_text()
    png = tconf.render_png(m, ids, str(out / "confusion.png"))
    assert Path(png).stat().st_size > 0


def test_metrics_task_confusion_matches_jax():
    """``task_confusion`` and ``real_class_preds``: episode-local argmax
    predictions mapped through each episode's class list, batched and
    single, equal to the JAX package's."""
    from litemkd_tpu.utils import metrics as jmetrics
    from litemkd_torch.utils import metrics as tmetrics
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(3, 7, 5)).astype(np.float32)
    classes = np.stack([rng.permutation(40)[:5] for _ in range(3)]).astype(np.int32)
    want = np.asarray(jmetrics.task_confusion(logits, classes))
    got = tmetrics.task_confusion(torch.from_numpy(logits), torch.from_numpy(classes))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmetrics.task_confusion(torch.from_numpy(logits[1]),
                                torch.from_numpy(classes[1])).numpy(), want[1])
    preds = rng.integers(0, 5, (3, 7))
    np.testing.assert_array_equal(
        tmetrics.real_class_preds(torch.from_numpy(preds),
                                  torch.from_numpy(classes)).numpy(),
        np.asarray(jmetrics.real_class_preds(preds, classes)))

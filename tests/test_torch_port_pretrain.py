"""The expert and pretrain stages from a JPEG tree, against the JAX package:
the aux frame rule of ``VideoStore.load``, the student trained teacher-free
by ``run_training`` on a sampler without teacher features, ``cli.pretrain``
(batches, epoch metrics, the saved checkpoint read back by the JAX
package's ``load_pretrain_init``, resume), expert extraction through
``cli.extract --mode_extract expert``, the pretrain CLI's config, and both
new CLIs in a fresh interpreter without JAX.

Frames are small random JPEGs written with PIL from numpy seeds; the data
path is exact (``np.array_equal``), and the model comparisons run in fp32
with the tolerances stated where they are used.
"""
import dataclasses
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

import litemkd_tpu.config as jax_config
import litemkd_tpu.data as jdata
from litemkd_tpu import native as jnative
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.cli import extract as jax_extract_cli
from litemkd_tpu.cli import pretrain as jax_pretrain_cli
from litemkd_tpu.data import video as jvideo
from litemkd_tpu.models.backbones.classifier_net import (
    ActionRecognitionNet as JaxARNet)
from litemkd_tpu.tools.torch_import import load_pretrain_init as jax_pretrain_init
from litemkd_tpu.train import run_training as jax_run_training
from litemkd_tpu.train.steps import create_train_state as jax_create_state
from litemkd_tpu.utils.logging import MetricsLogger as JaxLogger
from litemkd_tpu.utils.tree import deep_merge_variables
import litemkd_torch.config as torch_config
import litemkd_torch.data as tdata
from litemkd_torch import native as tnative
from litemkd_torch.cli import common as torch_common
from litemkd_torch.cli import extract as torch_extract_cli
from litemkd_torch.cli import pretrain as torch_pretrain_cli
from litemkd_torch.data import video as tvideo
from litemkd_torch.tools import extract as textract
from litemkd_torch.tools.weights import (classifier_net_state_dict_from_jax,
                                         student_state_dict_from_jax)
from litemkd_torch.train import run_training
from litemkd_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parents[1]
T, IMG = 4, 32
N_CLASSES, VIDS, N_TRAIN = 4, 6, 4     # per class; the rest are test videos


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A frame tree of 4 classes × 6 videos (4-8 random 40×48 frames each),
    split lists, and the same tree as a zip."""
    root = tmp_path_factory.mktemp("pretrain_tree")
    rng = np.random.default_rng(7)
    lines = ([], [])
    for c in range(N_CLASSES):
        for v in range(VIDS):
            vdir = root / "rgb" / f"class{c}" / f"vid_{c}_{v}"
            vdir.mkdir(parents=True)
            for f in range(T + (v % 3) * 2):
                Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                    vdir / f"{f:05d}.jpg")
            lines[v >= N_TRAIN].append(f"class{c}/vid_{c}_{v}")
    (root / "splits").mkdir()
    for name, ls in zip(("trainlist03.txt", "testlist03.txt"), lines):
        (root / "splits" / name).write_text("\n".join(ls) + "\n")
    with zipfile.ZipFile(root / "frames.zip", "w") as zf:
        for dirpath, _, files in os.walk(root / "rgb"):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                zf.write(full, os.path.relpath(full, root))
    return root


def _fp32_tiny(config, **model):
    base = config.preset("tiny")
    return base.replace(model=dataclasses.replace(
        base.model, compute_dtype="float32", trans_dropout=0.0, **model))


def _native_or_skip():
    if not (jnative.available() and tnative.available()):
        pytest.skip("the C++ clip decoder needs g++ and libjpeg")


def _force_pil(monkeypatch):
    monkeypatch.setattr(jvideo, "load_clip_native", lambda *a, **k: None)
    monkeypatch.setattr(tvideo, "load_clip_native", lambda *a, **k: None)


# ---------------------------------------------------------------------------
# The aux frame rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("source", ["dir", "zip"])
def test_aux_clip_loads_equal_jax(tree, source, use_native):
    """``VideoStore.load(frame_rule="aux")`` of every video of both splits,
    train and test transforms: ``np.array_equal`` to the JAX package's,
    drawing from the same rng stream."""
    if use_native:
        _native_or_skip()
    path = str(tree / ("frames.zip" if source == "zip" else "rgb"))
    args = (path, str(tree / "splits"), 3, T, IMG)
    js, ts = (m.VideoStore(*args, use_native=use_native) for m in (jdata, tdata))
    n = 0
    for train in (True, False):
        jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
        for c in ts.split(train).classes():
            for jr, tr in zip(js.split(train).videos_for_class(c),
                              ts.split(train).videos_for_class(c)):
                want = js.load(jr, train, jrng, frame_rule="aux")
                got = ts.load(tr, train, trng, frame_rule="aux")
                assert got.shape == (T, IMG, IMG, 3) and got.dtype == np.uint8
                np.testing.assert_array_equal(got, want)
                n += 1
    assert n == N_CLASSES * VIDS
    with pytest.raises(ValueError, match="frame_rule"):
        ts.load(tr, True, trng, frame_rule="other")


# ---------------------------------------------------------------------------
# Teacher-free student training (the repaired fault)
# ---------------------------------------------------------------------------

class _JaxCapture(JaxLogger):
    def __init__(self):
        super().__init__(print_freq=0)
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append((int(step), dict(scalars)))


class _Capture(MetricsLogger):
    def __init__(self):
        super().__init__(print_freq=0)
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append((int(step), dict(scalars)))


def _shift_bn_bias(tree, path=()):
    """Every BatchNorm bias at +3: no pre-activation near a ReLU kink, where
    a last-bit difference between the frameworks flips a gradient mask
    (``tests/test_torch_port_train.py``, ``jax_init``)."""
    if isinstance(tree, dict):
        return {k: _shift_bn_bias(v, path + (k,)) for k, v in tree.items()}
    if path[-1] == "bias" and "bn" in path[-2]:
        return tree + np.float32(3.0)
    return tree


class _x64:
    """JAX in float64 inside the block (``tests/test_torch_port_expert.py``)."""

    def __enter__(self):
        self.prev = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", self.prev)


def test_student_trains_teacher_free_like_jax(tree):
    """``run_training`` on a real-data sampler built with
    ``need_teacher=False`` (batches without teacher features): the JAX
    package trains the student teacher-free; the port did build and run
    the teacher, and raised. Two steps of the tiny expert student
    (resnet18_expert, TRX, TRXLoss) from the same weights, the port in
    fp32 against the JAX package computing in float64 (in fp32 its
    BatchNorm variance, E[x²]−E[x]², cancels; see
    ``tests/test_torch_port_expert.py``): per-step task_loss at rel 1e-4,
    final weights at rtol 1e-3 and atol 1e-3·max|p| (the tolerance of
    ``tests/test_torch_port_train.py::test_run_training_matches_jax``)."""
    data = dict(dataset="hmdb", rgb_path=str(tree / "rgb"),
                traintestlist=str(tree / "splits"), num_workers=0)
    model = dict(backbone="resnet18_expert", classifier="TRX",
                 trans_linear_in_dim=512)
    jcfg, cfg = (_fp32_tiny(c, **model) for c in (jax_config, torch_config))
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model,
                                                  compute_dtype="float64"))
    jcfg, cfg = (c.replace(
        data=dataclasses.replace(c.data, **data),
        distill=dataclasses.replace(c.distill, name="TRXLoss"),
        train=dataclasses.replace(c.train, training_iterations=4,
                                  learning_rate=1e-3, test_iters=(),
                                  print_freq=0)) for c in (jcfg, cfg))
    jsampler = jax_common.build_sampler(jcfg, need_teacher=False)
    sampler = torch_common.build_sampler(cfg, need_teacher=False)
    assert not sampler.with_teacher_feats
    first = jsampler.sample_batch(np.random.default_rng(0), 1, train=True)
    assert first.support_feats is None
    jlog, tlog = _JaxCapture(), _Capture()
    with _x64():
        state, t_vars = jax_create_state(jcfg, jax.random.key(0), first,
                                         episodes_per_step=2)
        assert t_vars is None
        variables = jax.tree_util.tree_map(
            np.asarray, {"params": state.params,
                         "batch_stats": state.batch_stats})
        variables["params"] = _shift_bn_bias(variables["params"])
        jstate, jt_vars, _ = jax_run_training(jcfg, jsampler, jlog,
                                              student_vars_init=variables)
        want = student_state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats}), cfg)
    got, _ = run_training(cfg, sampler, tlog, device="cpu",
                          student_state_dict=student_state_dict_from_jax(
                              variables, cfg))
    assert jt_vars is None and got.teacher is None and got.step == 2
    assert [s for s, _ in tlog.records] == [s for s, _ in jlog.records] == [1, 2]
    for (_, g), (_, w) in zip(tlog.records, jlog.records):
        assert g["task_loss"] == pytest.approx(w["task_loss"], rel=1e-4)
    for name, v in got.model.state_dict().items():
        if name.endswith(("num_batches_tracked", "norm_v.weight", "norm_v.bias",
                          "pe.pe")):
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# The pretrain CLI
# ---------------------------------------------------------------------------

def _pretrain_argv(tree, ckdir, *extra):
    return ["--preset", "tiny", "--dataset", "hmdb", "--rgb_path",
            str(tree / "rgb"), "--traintestlist", str(tree / "splits"),
            "--arch", "resnet18", "--epochs", "1", "--batch_size", "8",
            "--lr_2", "0.05", "--print_freq", "1", "-c", str(ckdir), *extra]


def _run_pretrain_clis(tree, out, mp):
    """Both packages' ``cli.pretrain`` from the same initial weights (the
    JAX package's init, carried across) in fp32: the clips each
    ``VideoStore.load`` returned, in order, the epoch metrics, and each
    run's final state (the port's is its ``TrainState``)."""
    for common, config in ((jax_common, jax_config), (torch_common, torch_config)):
        mp.setattr(common, "preset", lambda name, c=config: _fp32_tiny(c))
    loads = {"jax": [], "port": []}
    for name, mod in (("jax", jdata.VideoStore), ("port", tdata.VideoStore)):
        orig = mod.load

        def record(self, *a, _orig=orig, _name=name, **k):
            clip = _orig(self, *a, **k)
            loads[_name].append(clip)
            return clip

        mp.setattr(mod, "load", record)
    logs = {"jax": [], "port": []}
    mp.setattr(JaxLogger, "log", lambda self, step, s, force_print=False:
               logs["jax"].append(dict(s)))
    mp.setattr(MetricsLogger, "log", lambda self, step, s, force_print=False:
               logs["port"].append(dict(s)))

    jstate = jax_pretrain_cli.main(_pretrain_argv(tree, out / "jax"))
    n_classes = N_CLASSES
    jvars = jax.tree_util.tree_map(np.asarray, JaxARNet(
        num_classes=n_classes, depth=18, compute_dtype=jnp.float32).init(
            jax.random.key(_fp32_tiny(jax_config).train.seed),
            jnp.zeros((1, T, IMG, IMG, 3), jnp.uint8), train=False))
    create = torch_pretrain_cli.create_pretrain_state

    def from_jax_init(*a, **k):
        state = create(*a, **k)
        state.model.load_state_dict(classifier_net_state_dict_from_jax(jvars, 18),
                                    strict=True)
        return state

    mp.setattr(torch_pretrain_cli, "create_pretrain_state", from_jax_init)
    state = torch_pretrain_cli.main(_pretrain_argv(tree, out / "port")
                                    + ["--device", "cpu"])
    return loads, logs, jstate, state


@pytest.fixture(scope="module")
def pretrained(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("pretrain_runs")
    with pytest.MonkeyPatch.context() as mp:
        loads, logs, jstate, state = _run_pretrain_clis(tree, out, mp)
    return out, loads, logs, jstate, state


def _check_pretrain_runs(loads, logs, jstate, state):
    """The same clips in the same order (the init sample, 2 training
    batches of 8, the 8 test videos), epoch loss and accuracy at rel 1e-4
    (fp32; the trunk moves at lr_1 1e-6, the head at 0.05), the same test
    accuracy, and the same step and sample counts."""
    assert len(loads["port"]) == len(loads["jax"]) == 1 + 16 + 8
    for got, want in zip(loads["port"], loads["jax"]):
        np.testing.assert_array_equal(got, want)
    assert len(logs["port"]) == len(logs["jax"]) == 1
    got, want = logs["port"][0], logs["jax"][0]
    assert got.keys() == want.keys()
    for k in ("epoch_loss", "epoch_accuracy"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["test_accuracy"] == want["test_accuracy"]
    assert state.step == int(jstate.step) == 2
    assert state.episodes_seen == int(jstate.episodes_seen) == 16


def test_pretrain_cli_matches_jax(pretrained, tree):
    """With the default decoder (the C++ one where it builds), and the
    port's saved checkpoint: read back by the JAX package's
    ``load_pretrain_init`` (trunk) with the port's head, the JAX
    ``ActionRecognitionNet`` gives the port's logits (rtol 1e-4, atol
    1e-5·max|logit|)."""
    out, loads, logs, jstate, state = pretrained
    _check_pretrain_runs(loads, logs, jstate, state)
    ckpt = out / "port" / "checkpoint_16.pt"
    assert sorted(p.name for p in ckpt.parent.glob("*.pt")) == [ckpt.name]
    jcfg = _fp32_tiny(jax_config)
    net = JaxARNet(num_classes=N_CLASSES, depth=18, compute_dtype=jnp.float32)
    clips = np.stack(loads["port"][-4:])
    template = net.init(jax.random.key(5), jnp.asarray(clips[:1]), train=False)
    variables = deep_merge_variables(template,
                                     jax_pretrain_init(str(ckpt), jcfg, "resnet18"))
    fc = state.model.fc
    variables["params"] = {**variables["params"], "fc": {
        "kernel": fc.weight.detach().numpy().T, "bias": fc.bias.detach().numpy()}}
    want = np.asarray(net.apply(variables, jnp.asarray(clips), train=False))
    state.model.eval()
    with torch.inference_mode():
        got = state.model(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_pretrain_cli_matches_jax_with_pil(tree, tmp_path, monkeypatch):
    """As ``test_pretrain_cli_matches_jax``, with PIL decoding in both
    packages."""
    _force_pil(monkeypatch)
    _check_pretrain_runs(*_run_pretrain_clis(tree, tmp_path, monkeypatch))


def test_pretrain_resume_continues(pretrained, tree, monkeypatch):
    """``-r`` restores the newest checkpoint (weights, momentum, the StepLR
    position) and trains on: one more epoch ends at step 4, 32 samples, and
    a new keep-the-best checkpoint."""
    out = pretrained[0]
    for common, config in ((torch_common, torch_config),):
        monkeypatch.setattr(common, "preset", lambda name, c=config: _fp32_tiny(c))
    state = torch_pretrain_cli.main(_pretrain_argv(tree, out / "port")
                                    + ["-r", "--device", "cpu"])
    assert state.step == 4 and state.episodes_seen == 32
    assert state.scheduler.last_epoch == 4
    assert all(state.optimizer.state[p]["momentum_buffer"] is not None
               for p in state.model.parameters())
    assert sorted(p.name for p in (out / "port").glob("*.pt")) == \
        ["checkpoint_16.pt", "checkpoint_32.pt"]


# ---------------------------------------------------------------------------
# Expert extraction
# ---------------------------------------------------------------------------

def test_expert_extraction_matches_jax(pretrained, tree, tmp_path, monkeypatch):
    """``cli.extract --mode_extract expert --arch resnet18 -m`` the port's
    pretrain checkpoint, in both packages (fp32): the same
    ``<class>/<video>/feature.npy`` files, (T, 512) each, at rtol 1e-4 and
    atol 1e-5·max|feature|. Then a saved file that differs from what the
    trunk computes makes the port's self-consistency check raise."""
    for common, config in ((jax_common, jax_config), (torch_common, torch_config)):
        monkeypatch.setattr(common, "preset", lambda name, c=config: _fp32_tiny(c))
    ckpt = pretrained[0] / "port" / "checkpoint_16.pt"
    argv = ["--mode_extract", "expert", "--preset", "tiny", "--dataset", "hmdb",
            "--arch", "resnet18", "-m", str(ckpt), "--rgb_path",
            str(tree / "rgb"), "--traintestlist", str(tree / "splits"),
            "--batch_size", "8"]
    n = torch_extract_cli.main(argv + ["--out", str(tmp_path / "port"),
                                       "--device", "cpu"])
    jax_extract_cli.main(argv + ["--out", str(tmp_path / "jax")])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("feature.npy"))
    assert n == len(files) == N_CLASSES * VIDS
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("feature.npy"))
    for f in files:
        want, got = np.load(tmp_path / "jax" / f), np.load(tmp_path / "port" / f)
        assert got.shape == (T, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(), err_msg=str(f))

    save = textract._save_feature
    monkeypatch.setattr(textract, "_save_feature",
                        lambda out, c, v, f: save(out, c, v, f + 1.0))
    with pytest.raises(RuntimeError, match="self-consistency"):
        torch_extract_cli.main(argv + ["--out", str(tmp_path / "bad"),
                                       "--device", "cpu"])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv", [
    ["--rgb_path", "x", "--traintestlist", "y", "-c", "{dir}/c"],
    ["--preset", "expert_trx", "--dataset", "ucf", "--epochs", "3",
     "--batch_size", "4", "--lr_1", "1e-4", "--lr_2", "0.1", "--arch",
     "resnet34", "--remat", "--seq_len", "4", "--img_size", "112", "--seed",
     "5", "-lr", "0.3", "--init_checkpoint", "z.pt", "-r", "--debug"],
])
def test_pretrain_cli_config_equals_jax(argv, tmp_path, monkeypatch):
    """The config and the pretrain flags that the port's ``cli.pretrain``
    builds from an argv equal the JAX CLI's (read where it calls
    ``build_config``)."""
    argv = [a.format(dir=tmp_path) for a in argv]
    seen = {}

    def capture(args, base=None):
        seen["args"] = args
        raise _Stop

    monkeypatch.setattr(jax_pretrain_cli, "build_config", capture)
    with pytest.raises(_Stop):
        jax_pretrain_cli.main(argv)
    want = jax_common.build_config(seen["args"])
    _, args, got = torch_pretrain_cli.parse(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for k in ("epochs", "batch_size", "lr_1", "lr_2", "arch", "init_checkpoint",
              "learning_rate", "debug"):
        assert getattr(args, k) == getattr(seen["args"], k), k


def test_expert_clis_run_on_cpu_without_jax(tree, tmp_path):
    """A fresh interpreter pretrains resnet18 for one epoch through
    ``cli.pretrain``, extracts expert features from its checkpoint
    directory through ``cli.extract --mode_extract expert``, and ends with
    no JAX, flax or litemkd_tpu module loaded."""
    ck, out = tmp_path / "ck", tmp_path / "feats"
    data = ["--dataset", "hmdb", "--rgb_path", str(tree / "rgb"),
            "--traintestlist", str(tree / "splits"), "--seq_len", str(T),
            "--img_size", str(IMG), "--arch", "resnet18", "--device", "cpu"]
    code = (
        "import json, sys\n"
        "from litemkd_torch.cli import extract, pretrain\n"
        f"s = pretrain.main({data!r} + ['--epochs', '1', '-c', {str(ck)!r}])\n"
        f"n = extract.main({data!r} + ['--mode_extract', 'expert', '-m', "
        f"{str(ck)!r}, '--out', {str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'litemkd_tpu'))\n"
        "print(json.dumps({'bad': bad, 'step': s.step, 'n': n}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {"bad": [], "step": 2, "n": N_CLASSES * VIDS}
    assert np.load(next(out.rglob("feature.npy"))).shape == (T, 512)

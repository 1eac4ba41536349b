"""The port's bespoke fusion teachers (TSF, DGA, DGA2, two-road and its
video-axis variant) against the JAX package: logits from the same weights
carried both ways, one SGD step for TSF, DGA2 and two-road, TSF's
refusals, ``load_tsf_branches`` from a run.py ``.pt`` and from a run
directory of the port against JAX's grafting, feature extraction for the
new kinds and sides, and both teacher CLIs (``--fusion tsf --branch_ckpt``
and ``--fusion ThreeCross``) step for step against the JAX CLIs.

Tiny geometry of ``tests/test_torch_port_teacher.py``, fp32, dropout 0,
numpy-seeded episodes; the helpers are ``tests/test_torch_port_composer.py``'s.
Each tolerance is stated where it is used.
"""
import json

import numpy as np
import jax
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import extract as jax_extract_cli
from litemkd_tpu.cli import train_teacher as jax_tt_cli
from litemkd_tpu.tools.extract import extract_mfm_features as jax_extract
from litemkd_tpu.tools.torch_import import load_composed_checkpoint
from litemkd_tpu.train import teacher_steps as jts
from litemkd_tpu.utils import logging as jax_logging
import litemkd_torch.config as torch_config
from litemkd_torch.cli import extract as extract_cli
from litemkd_torch.cli import train_teacher as tt_cli
from litemkd_torch.models.teacher import init_mfm_
from litemkd_torch.ops import MultiSetTCT
from litemkd_torch.tools import weights
from litemkd_torch.tools.extract import extract_mfm_features
from litemkd_torch.train import make_mfm
from litemkd_torch.train.teacher_steps import load_tsf_branches
from litemkd_torch.utils import logging as torch_logging
from test_torch_port_backbones import _np_tree
from test_torch_port_composer import (_two_torch_threads,  # noqa: F401
                                      assert_same_teacher,
                                      assert_train_step_matches_jax, configs,
                                      port_model, through_jax_file)
from test_torch_port_teacher import (D, MODS, N_CLASSES, N_TEST, N_TRAIN, QPC,
                                     SHOT, T, WAY, _cfg, _close, _episode_batch,
                                     _stores, feature_root)  # noqa: F401

WEIGHTS = (1.0, 0.5, 0.25)
BESPOKE = ["tsf", "dga", "dga2", "two_road", "two_road_videoaxis"]


def _kw(kind):
    return {"score_weights": WEIGHTS} if kind == "tsf" else {}


@pytest.mark.parametrize("kind", BESPOKE)
def test_bespoke_kind_matches_jax_through_its_file(kind, tmp_path):
    """Each bespoke kind: the port's weights through a ``.pt`` into the JAX
    package, the same logits (TSF: each modality's too, with weights 1,
    0.5, 0.25), and back bitwise."""
    jcfg, cfg = configs(kind)
    model = port_model(cfg, kind, **_kw(kind))
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    got, want = assert_same_teacher(kind, jcfg, cfg, model, v, **_kw(kind))
    if kind == "tsf":
        assert list(got["per_modality"]) == list(MODS)
        for m in MODS:
            _close(got["per_modality"][m].numpy(), want["per_modality"][m])


@pytest.mark.parametrize("kind", ["tsf", "dga2", "two_road"])
def test_bespoke_train_step_matches_jax(kind, tmp_path, monkeypatch):
    assert_train_step_matches_jax(kind, tmp_path, monkeypatch, **_kw(kind))


def test_tsf_refusals_raise_in_both(tmp_path):
    """TSF with a weight count other than its modalities', and a TSF file
    read with two modalities, raise ValueError in both packages."""
    jcfg, cfg = configs("tsf")
    with pytest.raises(ValueError, match="one weight per modality"):
        make_mfm(cfg, "tsf", score_weights=(1.0, 0.5))
    sf, sl, qf, _ = _episode_batch(0, 1)
    with pytest.raises(ValueError, match="one weight per modality"):
        jts.make_mfm(jcfg, kind="tsf", score_weights=(1.0, 0.5)).init(
            jax.random.key(0), sf, sl, qf, False)
    path = tmp_path / "tsf.pt"
    torch.save(port_model(cfg, "tsf").state_dict(), path)
    jcfg2, cfg2 = configs("tsf", n=2)
    with pytest.raises(ValueError, match="3-modality"):
        load_composed_checkpoint(str(path), jcfg2, "tsf")
    with pytest.raises(ValueError, match="3-modality"):
        weights.load_reference_fusion_state_dict(str(path), cfg2, "tsf")


# ---------------------------------------------------------------------------
# Grafting experts into TSF
# ---------------------------------------------------------------------------

def _expert_tct(temp_set, seed):
    """A TCT stack of ``temp_set`` at the tiny geometry, with torch's
    random init from ``seed`` (LayerNorms perturbed off identity, so a
    graft that skipped them would show)."""
    tct = init_mfm_(MultiSetTCT(WAY, SHOT, T, D, 24, temp_set=temp_set,
                                dropout=0.0), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for t in tct.transformers:
            t.norm_k.weight.add_(torch.rand(24, generator=g) - 0.5)
            t.norm_k.bias.add_(torch.rand(24, generator=g) - 0.5)
    return tct


def _runpy_artifact(path, temp_set, seed):
    """A run.py expert artifact: a resnet trunk key and the TCT ModuleList
    at ``transformers.{i}``."""
    sd = dict(_expert_tct(temp_set, seed).state_dict())
    sd["resnet.0.weight"] = torch.zeros(4, 3, 7, 7)
    torch.save(sd, path)
    return str(path)


def _port_run(directory, cfg, temp_set, seed):
    """A run directory of the port: ``config.json`` and a
    ``checkpoint_8.pt`` whose ``classifier.transformers`` holds the TCT
    stack (flat for one set, ``.{i}`` for several), as ``cli.train`` of an
    expert writes them."""
    directory.mkdir()
    run_cfg = cfg.replace(model=cfg.model.__class__(
        **{**cfg.model.__dict__, "temp_set": tuple(temp_set)}))
    (directory / "config.json").write_text(run_cfg.to_json())
    tct = _expert_tct(temp_set, seed).state_dict()
    if len(temp_set) == 1:
        tct = {"transformers." + k[len("transformers.0."):]: v
               for k, v in tct.items()}
    torch.save({"model_state_dict": {f"classifier.{k}": v
                                     for k, v in tct.items()}},
               directory / "checkpoint_8.pt")
    return str(directory)


@pytest.mark.parametrize("temp_set", [(2,), (2, 3)])
def test_load_tsf_branches_matches_jax(temp_set, tmp_path):
    """A TSF teacher of ``temp_set`` grafted from run.py artifacts with the
    same sets (rgb and flow; depth keeps its init) equals the JAX package's
    grafting of the same files, bitwise; a one-set artifact's flat head
    fills the branch's set. A run directory of the port holding the same
    heads grafts the same weights."""
    jcfg, cfg = configs("tsf")
    jcfg = jcfg.replace(model=jcfg.model.__class__(
        **{**jcfg.model.__dict__, "temp_set": temp_set}))
    cfg = cfg.replace(model=cfg.model.__class__(
        **{**cfg.model.__dict__, "temp_set": temp_set}))
    model = port_model(cfg, "tsf")
    v = through_jax_file(model, jcfg, "tsf", tmp_path / "k.pt")
    pts = {"rgb": _runpy_artifact(tmp_path / "rgb.pt", temp_set, 1),
           "flow": _runpy_artifact(tmp_path / "flow.pt", temp_set, 2)}
    want = weights.fusion_state_dict_from_jax(
        {"params": _np_tree(jts.load_tsf_branches(v["params"], pts,
                                                  temp_set=temp_set))},
        cfg, "tsf")
    before = {k: t.clone() for k, t in model.state_dict().items()}
    load_tsf_branches(model, pts, temp_set=temp_set)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    key = f"transformers.{len(temp_set) - 1}.k_linear.weight"
    assert not torch.equal(got[f"m1_branch.{key}"], before[f"m1_branch.{key}"])
    assert torch.equal(got[f"skeleton_branch.{key}"],
                       before[f"skeleton_branch.{key}"])
    dirs = {"rgb": _port_run(tmp_path / "rgb_run", cfg, temp_set, 1),
            "flow": _port_run(tmp_path / "flow_run", cfg, temp_set, 2)}
    fresh = port_model(cfg, "tsf")
    load_tsf_branches(fresh, dirs, temp_set=temp_set)
    for k, t in fresh.state_dict().items():
        if k.startswith(("m1_branch", "flow_branch")):
            assert torch.equal(t, got[k]), k


def test_grafting_refusals_raise_in_both(tmp_path):
    """A two-set artifact read in the order (2, 3) into branches of one set
    is a temp_set mismatch, and grafting into a teacher that is not TSF a
    KeyError, in both packages; so is a port run directory whose
    ``config.json`` gives other sets."""
    jcfg, cfg = configs("tsf")
    model = port_model(cfg, "tsf")
    v = through_jax_file(model, jcfg, "tsf", tmp_path / "k.pt")
    pt = {"rgb": _runpy_artifact(tmp_path / "rgb.pt", (2, 3), 1)}
    with pytest.raises(ValueError, match="temp_set mismatch"):
        jts.load_tsf_branches(v["params"], pt, temp_set=(2, 3))
    with pytest.raises(ValueError, match="temp_set mismatch"):
        load_tsf_branches(model, pt, temp_set=(2, 3))
    with pytest.raises(ValueError, match="temp_set mismatch"):
        load_tsf_branches(model, {"rgb": _port_run(tmp_path / "run", cfg,
                                                   (2, 3), 1)},
                          temp_set=cfg.model.temp_set)
    jcfg3, cfg3 = configs("ThreeCross")
    dga = port_model(cfg3, "ThreeCross")
    vd = through_jax_file(dga, jcfg3, "ThreeCross", tmp_path / "c.pt")
    with pytest.raises(KeyError, match="fusion tsf"):
        jts.load_tsf_branches(vd["params"], pt, temp_set=(2, 3))
    with pytest.raises(KeyError, match="fusion tsf"):
        load_tsf_branches(dga, pt, temp_set=(2, 3))


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,side", [
    ("dga", 0),
    ("ThreeTRXCombination", 0),         # the dump's own shifts
    ("TwoCombinationTemTroShiftTRX_faithful", 1),
])
def test_extract_features_match_jax(kind, side, feature_root, tmp_path):
    """The fixture's whole tree (batches of 4 and a remainder) through both
    packages' extraction tools from the same weights: the same files, each
    within 1e-4·max|feature|."""
    jcfg, cfg = configs(kind)
    model = port_model(cfg, kind)
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    jstore, store = _stores(feature_root)
    n_j = jax_extract(jcfg, jstore, v, str(tmp_path / "jax"),
                      jstore.class_names, batch_size=4, fusion_kind=kind,
                      side=side)
    n = extract_mfm_features(store, model, str(tmp_path / "port"), 4,
                             fusion_kind=kind, side=side)
    assert n == n_j == N_CLASSES * (N_TRAIN + N_TEST)
    for f in sorted((tmp_path / "jax").rglob("feature.npy")):
        rel = f.relative_to(tmp_path / "jax")
        _close(np.load(tmp_path / "port" / rel), np.load(f), what=str(rel))


@pytest.mark.parametrize("kind", ["TwoFusionBatchFusion",
                                  "ThreeFusion3_videoaxis"])
def test_batch_dependent_extract_matches_jax(kind, feature_root, tmp_path):
    """Kinds whose fused features depend on the batch (scalar statistics
    over it, attention across its videos): ``extract`` of one batch of 7
    videos equals the JAX package's within 1e-4·max; and both packages'
    extraction tools refuse the fixture's tree alike, since the first
    training video fused alone no longer matches its batch's file (their
    shared self-consistency check; that video's depth file is missing and
    zero-fills, so its lone statistics are degenerate)."""
    jcfg, cfg = configs(kind)
    model = port_model(cfg, kind)
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    jm = jts.make_mfm(jcfg, batched=False, kind=kind)
    rng = np.random.default_rng(5)
    feats = {m: rng.normal(size=(7, T, D)).astype(np.float32) for m in MODS}
    with torch.no_grad():
        got = model.extract({m: torch.from_numpy(f) for m, f in feats.items()})
    _close(got.numpy(), jm.apply(v, feats, method=jm.extract))
    jstore, store = _stores(feature_root)
    with pytest.raises(RuntimeError, match="self-consistency"):
        jax_extract(jcfg, jstore, v, str(tmp_path / "jax"),
                    jstore.class_names, batch_size=4, fusion_kind=kind)
    with pytest.raises(RuntimeError, match="self-consistency"):
        extract_mfm_features(store, model, str(tmp_path / "port"), 4,
                             fusion_kind=kind)


def test_extract_refusals_raise_in_both(feature_root, tmp_path):
    """TSF has no ``extract``, and a query-side dump of a teacher whose
    ``extract`` takes no side is refused, in both packages."""
    jstore, store = _stores(feature_root)
    for kind, side, err in (("tsf", 0, AttributeError), ("dga", 1, ValueError)):
        jcfg, cfg = configs(kind)
        model = port_model(cfg, kind)
        v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
        with pytest.raises(err):
            jax_extract(jcfg, jstore, v, str(tmp_path / "jax"),
                        jstore.class_names, batch_size=4, fusion_kind=kind,
                        side=side)
        with pytest.raises(err):
            extract_mfm_features(store, model, str(tmp_path / "port"), 4,
                                 fusion_kind=kind, side=side)


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _geo(root):
    return ["--preset", "tiny", "--dataset", "hmdb", "--feature_root",
            str(root), "--traintestlist", str(root / "splits"), "--way",
            str(WAY), "--shot", str(SHOT), "--query_per_class", str(QPC),
            "--query_per_class_test", "1", "--seq_len", str(T),
            "--trans_linear_in_dim", str(D), "--trans_linear_out_dim", "24",
            "--trans_num", "1", "--trans_dropout", "0", "--debug"]


def _run_both(monkeypatch, argv):
    """Both teacher CLIs on ``argv`` (2 steps of 2 episodes, an 8-episode
    eval at the end): their per-step metrics and eval summaries."""
    from litemkd_tpu.train import loop as jax_loop
    logs = {"jax": [], "port": []}

    def capture(which):
        def log(self, step, scalars, force_print=False):
            logs[which].append({k: float(scalars[k])
                                for k in ("task_loss", "accuracy")})
        return log

    monkeypatch.setattr(jax_logging.MetricsLogger, "log", capture("jax"))
    monkeypatch.setattr(torch_logging.MetricsLogger, "log", capture("port"))
    summaries = []
    real = jax_loop.run_eval
    monkeypatch.setattr(jax_loop, "run_eval", lambda *a, **k: summaries.append(
        real(*a, **k)) or summaries[-1])
    train = ["--training_iterations", "4", "--test_iters", "4", "--sch", "100",
             "-lr", "1e-2", "--num_test_tasks", "8"]
    jax_tt_cli.main(argv + train)
    _, history = tt_cli.main(argv + train + ["--device", "cpu"])
    return logs, summaries, history


def _assert_same_runs(logs, summaries, history):
    """Per step: task_loss within 1e-5 relative and the same accuracy (a
    mean of per-episode fractions, summed in another order: within 1e-6);
    the eval's accuracy, CI and task count equal."""
    assert len(logs["port"]) == len(logs["jax"]) == 2
    for got, want in zip(logs["port"], logs["jax"]):
        assert got["task_loss"] == pytest.approx(want["task_loss"], rel=1e-5)
        assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6)
    assert len(history) == len(summaries) == 1
    for k in ("accuracy", "confidence", "n_tasks"):
        assert history[0][k] == pytest.approx(summaries[0][k], abs=1e-9), k


def test_tsf_cli_with_grafted_experts_matches_jax(feature_root, tmp_path,
                                                  monkeypatch):
    """``--fusion tsf --score_weights 1 0.5 0.25`` with every branch grafted
    from a run.py artifact (``--branch_ckpt MODALITY=PATH``, so both
    packages start from the same weights): the same losses, accuracies and
    eval."""
    grafts = []
    for i, m in enumerate(MODS):
        grafts += ["--branch_ckpt",
                   f"{m}={_runpy_artifact(tmp_path / f'{m}.pt', (2,), i)}"]
    argv = _geo(feature_root) + ["--fusion", "tsf", "--score_weights", "1",
                                 "0.5", "0.25"] + grafts
    _assert_same_runs(*_run_both(monkeypatch, argv))


def test_composer_cli_matches_jax(feature_root, tmp_path, monkeypatch):
    """``--fusion ThreeCross -m <the port's .pt>``: the same losses,
    accuracies and eval in both packages."""
    _, cfg = configs("ThreeCross")
    init = tmp_path / "init.pt"
    torch.save(port_model(cfg, "ThreeCross").state_dict(), init)
    argv = _geo(feature_root) + ["--fusion", "ThreeCross", "-m", str(init)]
    _assert_same_runs(*_run_both(monkeypatch, argv))


def test_cli_refusals_raise_in_both(feature_root, tmp_path):
    """``--branch_ckpt`` without ``=`` and a ``.pt`` for extraction of a
    kind other than mfm are usage errors, and a query-side extraction of a
    side-symmetric kind a ValueError, in both packages' CLIs."""
    bad = ["--preset", "tiny", "--dataset", "synthetic", "--fusion", "tsf",
           "--branch_ckpt", "rgb", "--debug"]
    with pytest.raises(SystemExit):
        jax_tt_cli.main(bad)
    with pytest.raises(SystemExit):
        tt_cli.main(bad + ["--device", "cpu"])
    ext = ["--mode_extract", "mfm", "--out", str(tmp_path / "out")] + [
        a for a in _geo(feature_root) if a != "--debug"]
    for extra, err in ((["--fusion", "dga", "-m", str(tmp_path / "x.pt")],
                        SystemExit),
                       (["--fusion", "dga", "--extract_side", "query"],
                        ValueError)):
        with pytest.raises(err):
            jax_extract_cli.main(ext + extra)
        with pytest.raises(err):
            extract_cli.main(ext + extra + ["--device", "cpu"])


def test_extract_cli_dumps_either_side(feature_root, tmp_path):
    """``cli.extract --fusion TwoCombinationTemTroShiftTRX_faithful`` from a
    fresh init, once with ``--extract_side support`` and once with
    ``query``: the whole tree both times, and the trees differ (the
    3-stream branch sits on the support side only)."""
    ext = ["--mode_extract", "mfm", "--fusion",
           "TwoCombinationTemTroShiftTRX_faithful", "--device", "cpu"] + [
        a for a in _geo(feature_root) if a != "--debug"]
    trees = {}
    for side in ("support", "query"):
        out = tmp_path / side
        n = extract_cli.main(ext + ["--out", str(out), "--extract_side", side])
        assert n == N_CLASSES * (N_TRAIN + N_TEST)
        trees[side] = {f.relative_to(out): np.load(f)
                       for f in out.rglob("feature.npy")}
    assert trees["support"].keys() == trees["query"].keys()
    assert all(not np.allclose(trees["support"][k], trees["query"][k])
               for k in trees["support"])

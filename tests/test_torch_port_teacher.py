"""The ported MFM fusion teacher against the JAX package: the encoder layer
(and torch's own ``nn.TransformerEncoderLayer``), the trainable PE, the
multi-set TCT, the teacher's forward for 3 and 4 modalities, extraction
with its dump-vs-live asymmetry, the weight converter and the reference
loader, one train step, the feature stores and episode samplers, the
synthetic multi-modal source, the extraction tool, and the teacher CLI in
both packages; then the CLIs in a fresh interpreter with no JAX loaded.

Tiny geometry (``tests/test_teacher_train.py``), fp32, ``trans_dropout=0``,
numpy-seeded inputs; the JAX side runs ``tct_attention_xla`` (no Pallas).
Each tolerance is stated where it is used.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.cli import train_teacher as jax_tt_cli
from litemkd_tpu.data.features import MultiModalFeatureStore as JaxMMStore
from litemkd_tpu.data.multimodal import MultiModalEpisodeSampler as JaxMMSampler
from litemkd_tpu.models.teacher import EncoderLayer as JaxEncoderLayer
from litemkd_tpu.models.teacher import MFMTeacher as JaxMFMTeacher
from litemkd_tpu.ops.positional import TrainablePE as JaxTrainablePE
from litemkd_tpu.ops.tct import MultiSetTCT as JaxMultiSetTCT
from litemkd_tpu.tools.extract import extract_mfm_features as jax_extract
from litemkd_tpu.tools.torch_export import export_mfm_checkpoint
from litemkd_tpu.train import teacher_steps as jts
from litemkd_tpu.train.schedule import make_optimizer as jax_make_optimizer
from litemkd_tpu.train.steps import TrainState as JaxTrainState
import litemkd_torch.config as torch_config
from litemkd_torch.cli import extract as extract_cli
from litemkd_torch.cli import train_teacher as tt_cli
from litemkd_torch.data import MultiModalEpisodeSampler, MultiModalFeatureStore
from litemkd_torch.models import make_backbone
from litemkd_torch.models.teacher import EncoderLayer, MFMTeacher
from litemkd_torch.ops import MultiSetTCT, TrainablePE
from litemkd_torch.tools import weights
from litemkd_torch.tools.extract import extract_mfm_features
from litemkd_torch.train import (create_mfm_train_state, make_mfm,
                                 make_mfm_eval_step, make_mfm_train_step,
                                 to_device, train_loop)
from litemkd_torch.utils.logging import MetricsLogger

REPO = Path(__file__).resolve().parent.parent
WAY, SHOT, QPC, T, D = 3, 2, 2, 4, 32
MODS = ("rgb", "depth", "flow")
N_CLASSES, N_TRAIN, N_TEST = 5, 5, 4


def _cfg(make, modalities=MODS, **train):
    base = make("tiny")
    return base.replace(
        episode=dataclasses.replace(base.episode, way=WAY, shot=SHOT,
                                    query_per_class=QPC,
                                    query_per_class_test=1, seq_len=T),
        model=dataclasses.replace(base.model, trans_linear_in_dim=D,
                                  trans_linear_out_dim=24, trans_num=1,
                                  modalities=tuple(modalities),
                                  trans_dropout=0.0, compute_dtype="float32"),
        train=dataclasses.replace(base.train, tasks_per_batch=2,
                                  training_iterations=4, num_test_tasks=2,
                                  sch=(100,), **train))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _feats(rng, e, n, modalities=MODS):
    return {m: rng.normal(size=(e, n, T, D)).astype(np.float32)
            for m in modalities}


def _episode_batch(seed, e=2, modalities=MODS):
    rng = np.random.default_rng(seed)
    sl = np.stack([rng.permutation(np.repeat(np.arange(WAY), SHOT))
                   for _ in range(e)]).astype(np.int32)
    ql = np.stack([rng.permutation(np.repeat(np.arange(WAY), QPC))
                   for _ in range(e)]).astype(np.int32)
    return (_feats(rng, e, WAY * SHOT, modalities), sl,
            _feats(rng, e, WAY * QPC, modalities), ql)


def _jax_mfm(jcfg, seed, modalities=MODS):
    """A batched JAX MFM teacher and its variables (numpy leaves)."""
    model = jts.make_mfm(jcfg)
    sf, sl, qf, _ = _episode_batch(seed, 1, modalities)
    variables = jax.jit(model.init, static_argnums=4)(
        jax.random.key(seed), sf, sl, qf, False)
    return model, _np_tree(variables)


@pytest.fixture(scope="module")
def jax_mfm():
    """The 3-modality tiny JAX teacher most tests share."""
    return _jax_mfm(_cfg(jax_config.preset), 3)


def _port_mfm(cfg, variables, **kw):
    model = make_mfm(cfg) if not kw else MFMTeacher(
        WAY, SHOT, T, D, 24, cfg.model.temp_set, depth=cfg.model.trans_num,
        modalities=cfg.model.modalities, dropout=0.0, **kw)
    model.load_state_dict(weights.mfm_state_dict_from_jax(variables, cfg),
                          strict=True)
    return model.eval()


def _close(got, want, rel=1e-4, what=""):
    """|got − want| ≤ rel·max|want| elementwise (fp32 on both sides,
    products summed in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_encoder_layer_matches_jax_and_torch():
    """The port's EncoderLayer == JAX's EncoderLayer and == torch's
    nn.TransformerEncoderLayer (eval mode, its fast path) on the same
    weights, within rtol 2e-4 (``tests/test_teacher.py``'s tolerance); in
    train mode with dropout 0 it computes exactly what eval mode does."""
    d_model, nhead, dim_ff = 16, 2, 24
    x = np.random.default_rng(0).normal(size=(2, 5, d_model)).astype(np.float32)
    jlayer = JaxEncoderLayer(d_model, nhead, dim_ff=dim_ff)
    params = _np_tree(jlayer.init(jax.random.key(0), jnp.asarray(x), False))
    want = np.asarray(jlayer.apply(params, jnp.asarray(x), False))
    sd = {}
    weights._encoder_layer(sd, "l", params["params"])
    sd = {k[2:]: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    layer = EncoderLayer(d_model, nhead, dim_ff, dropout=0.0)
    layer.load_state_dict(sd, strict=True)
    tl = torch.nn.TransformerEncoderLayer(d_model, nhead, dim_ff,
                                          batch_first=True)
    tl.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x))
        got_train = layer.train()(torch.from_numpy(x))
        torch_out = tl.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), torch_out, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, got_train)


def test_trainable_pe_matches_jax():
    """Embedding + LayerNorm on (N, T', D) with T' < max_len, rtol 1e-5."""
    x = np.random.default_rng(1).normal(size=(3, T - 1, D)).astype(np.float32)
    jpe = JaxTrainablePE(T, D, 0.0)
    v = _np_tree(jpe.init(jax.random.key(1), jnp.asarray(x), train=False))
    want = np.asarray(jpe.apply(v, jnp.asarray(x), train=False))
    pe = TrainablePE(T, D, 0.0)
    pe.load_state_dict({
        "position_embeddings.weight": torch.tensor(
            v["params"]["position_embeddings"]),
        "LayerNorm.weight": torch.tensor(v["params"]["LayerNorm_0"]["scale"]),
        "LayerNorm.bias": torch.tensor(v["params"]["LayerNorm_0"]["bias"])},
        strict=True)
    with torch.no_grad():
        got = pe.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_multiset_tct_matches_jax():
    """temp_set (2, 3): the mean of two TCTs' logits, per episode, within
    1e-4·max|logits|; the sets sit at ``transformers.0`` and ``.1`` in
    temp_set order."""
    sf, sl, qf, _ = _episode_batch(2)
    jm = JaxMultiSetTCT(way=WAY, shot=SHOT, seq_len=T, in_dim=D, out_dim=24,
                        temp_set=(2, 3), dropout=0.0)
    v = _np_tree(jax.jit(lambda *a: jm.init(*a, train=False))(
        jax.random.key(2), sf["rgb"][0], sl[0], qf["rgb"][0]))
    apply = jax.jit(lambda *a: jm.apply(v, *a, train=False))
    want = np.stack([np.asarray(apply(sf["rgb"][i], sl[i], qf["rgb"][i]))
                     for i in range(2)])
    m = MultiSetTCT(WAY, SHOT, T, D, 24, temp_set=(2, 3), dropout=0.0)
    sd = {}
    for i, s in enumerate((2, 3)):
        sd.update({f"transformers.{i}.{k}": t for k, t in
                   weights.tct_state_dict_from_jax(v["params"][f"tct_{s}"], D,
                                                   int(1.5 * T)).items()})
    m.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(sf["rgb"]), torch.from_numpy(sl).long(),
                       torch.from_numpy(qf["rgb"])).numpy()
    _close(got, want)


@pytest.mark.parametrize("modalities", [MODS, MODS + ("skeleton",)])
def test_mfm_forward_matches_jax(jax_mfm, modalities):
    """Logits of 2 episodes, 3 modalities (ThreeStreamFusion) and 4
    (MultiStreamFusion), within 1e-4·max|logits|, and equal accuracies."""
    jcfg = _cfg(jax_config.preset, modalities)
    cfg = _cfg(torch_config.preset, modalities)
    jmodel, v = jax_mfm if modalities == MODS else _jax_mfm(jcfg, 3, modalities)
    sf, sl, qf, ql = _episode_batch(4, 2, modalities)
    want = np.asarray(jax.jit(jmodel.apply, static_argnums=4)(
        v, sf, sl, qf, False)["logits"])
    model = _port_mfm(cfg, v)
    b = to_device((sf, sl, qf, ql), "cpu")
    with torch.no_grad():
        got = model(b[0], b[1], b[2])["logits"].numpy()
    _close(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("third_shift", ["reference", "right"])
def test_extract_matches_jax(jax_mfm, third_shift):
    """``extract`` on (N, T, D) features within 1e-4·max. In "reference"
    mode extraction rolls m3 left while the live ``fuse`` leaves it as it
    is (the released dump-vs-live asymmetry), so the two differ; in
    "right" mode both roll it right and agree exactly."""
    cfg = _cfg(torch_config.preset)
    _, v = jax_mfm
    jm = JaxMFMTeacher(WAY, SHOT, T, D, 24, depth=1, modalities=MODS,
                       dropout=0.0, third_shift=third_shift)
    feats = {m: f[0] for m, f in _feats(np.random.default_rng(6), 1, 7).items()}
    want = np.asarray(jax.jit(lambda f: jm.apply(v, f, method=jm.extract))(
        feats))
    live = np.asarray(jax.jit(lambda f: jm.apply(v, f, False, method=jm.fuse))(
        feats))
    model = _port_mfm(cfg, v, third_shift=third_shift)
    tf = {m: torch.from_numpy(f) for m, f in feats.items()}
    with torch.no_grad():
        got, got_live = model.extract(tf).numpy(), model.fuse(tf).numpy()
    _close(got, want)
    _close(got_live, live)
    if third_shift == "reference":
        assert np.abs(got - got_live).max() > 1e-3 * np.abs(got).max()
    else:
        np.testing.assert_array_equal(got, got_live)


def test_weights_equal_export_and_pt_loads_strict(tmp_path):
    """``mfm_state_dict_from_jax`` == ``export_mfm_checkpoint``'s dict, key
    for key and in order; the exported ``.pt`` loads strictly into the port
    through ``load_reference_mfm_state_dict``, whose geometry guards raise
    on a shallower trans_num, another seq_len and fewer TCT sets."""
    jcfg = _cfg(jax_config.preset).replace(model=dataclasses.replace(
        _cfg(jax_config.preset).model, temp_set=(3, 2)))
    cfg = torch_config.Config.from_dict(json.loads(jcfg.to_json()))
    _, v = _jax_mfm(jcfg, 7)
    path = str(tmp_path / "mfm.pt")
    want = export_mfm_checkpoint(v, jcfg, path)
    got = weights.mfm_state_dict_from_jax(v, cfg)
    assert list(got) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    model = make_mfm(cfg)
    model.load_state_dict(weights.load_reference_mfm_state_dict(path, cfg),
                          strict=True)
    assert set(model.state_dict()) == set(want)
    bad = [dataclasses.replace(cfg.model, trans_num=0),
           dataclasses.replace(cfg.model, temp_set=(3,))]
    for m in bad:
        with pytest.raises(ValueError):
            weights.load_reference_mfm_state_dict(path, cfg.replace(model=m))
    with pytest.raises(ValueError, match="seq_len"):
        weights.load_reference_mfm_state_dict(path, cfg.replace(
            episode=dataclasses.replace(cfg.episode, seq_len=T + 1)))


def test_train_step_matches_jax(jax_mfm):
    """One SGD step on 2 episodes against the JAX package's train step
    (dropout 0): task_loss within 1e-5 relative and accuracy equal; every
    gradient within 2e-4·max|g| (the JAX package's own fp32 error, against
    ``jax.grad`` of its loss); updated parameters within lr·2e-4·max|g| +
    1e-6·max|p|."""
    jcfg = _cfg(jax_config.preset, learning_rate=1e-2)
    cfg = _cfg(torch_config.preset, learning_rate=1e-2)
    jmodel, v = jax_mfm
    sf, sl, qf, ql = _episode_batch(8)
    jbatch = jts.EpisodeBatch(sf, sl, qf, ql)
    t = jcfg.train
    tx = jax_make_optimizer(t.optimizer, t.learning_rate, t.sch, t.sch_gamma,
                            t.tasks_per_batch)
    zero = jnp.zeros((), jnp.int32)
    jstate = JaxTrainState(step=zero, episodes_seen=zero, params=v["params"],
                           batch_stats={}, opt_state=tx.init(v["params"]),
                           rng=jax.random.key(8), tx=tx)

    def loss(p):
        logits = jmodel.apply({"params": p}, sf, sl, qf, False)["logits"]
        return jnp.sum(jax.vmap(jts.sum_ce)(logits, ql) / 2)

    jgrads = _np_tree(jax.jit(jax.grad(loss))(v["params"]))
    new_state, jm = jax.jit(jts.make_mfm_train_step(jcfg))(jstate, jbatch)
    state = create_mfm_train_state(
        cfg, "cpu", state_dict=weights.mfm_state_dict_from_jax(v, cfg))
    m = make_mfm_train_step(cfg)(state, to_device(jbatch, "cpu"))
    assert m["task_loss"].item() == pytest.approx(float(jm["task_loss"]),
                                                  rel=1e-5)
    assert m["accuracy"].item() == float(jm["accuracy"])
    want_g = weights.mfm_state_dict_from_jax({"params": jgrads}, cfg)
    want_p = weights.mfm_state_dict_from_jax(
        {"params": _np_tree(new_state.params)}, cfg)
    got = dict(state.model.named_parameters())
    g_max = max(np.abs(want_g[n].numpy()).max() for n in got)
    for n, p in got.items():
        if n.endswith(("norm_v.weight", "norm_v.bias")):
            assert p.grad is None, n      # unused, as in the reference
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(), rtol=0,
                                   atol=2e-4 * g_max, err_msg=n)
        wp = want_p[n].numpy()
        np.testing.assert_allclose(p.detach().numpy(), wp, rtol=0,
                                   atol=1e-2 * 2e-4 * g_max
                                   + 1e-6 * np.abs(wp).max(), err_msg=n)
    assert state.step == 1 and state.episodes_seen == 2


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def feature_root(tmp_path_factory):
    """Per-modality trees: class-structured features (prototype + noise, so
    accuracy sits mid-curve); one video has no depth file and the flow tree
    lacks a whole class folder (both zero-fill; the lookup goes by class
    name)."""
    root = tmp_path_factory.mktemp("mmfeat")
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(len(MODS), N_CLASSES, T, D)).astype(np.float32)
    train_lines, test_lines = [], []
    for c in range(N_CLASSES):
        cname = f"class{c:02d}"
        for v in range(N_TRAIN + N_TEST):
            vname = f"vid_{c:02d}_{v:02d}"
            for mi, m in enumerate(MODS):
                if (m == "depth" and v == 0) or (m == "flow" and c == 1):
                    continue
                d = root / m / cname / vname
                d.mkdir(parents=True)
                feat = protos[mi, c] + 2.0 * rng.normal(size=(T, D))
                np.save(d / "feature.npy", feat.astype(np.float32))
            (train_lines if v < N_TRAIN else test_lines).append(
                f"{cname}/{vname}")
    ann = root / "splits"
    ann.mkdir()
    (ann / "trainlist03.txt").write_text("\n".join(train_lines) + "\n")
    (ann / "testlist03.txt").write_text("\n".join(test_lines) + "\n")
    return root


def _stores(root):
    paths = {m: str(root / m) for m in MODS}
    args = (paths, str(root / "splits"), 3, T, D)
    return JaxMMStore(*args), MultiModalFeatureStore(*args)


def test_feature_store_and_sampler_match_jax(feature_root):
    """Same split indices and class names, and np.array_equal episode
    batches from one seed in both splits, zero-filled modalities
    included."""
    jstore, store = _stores(feature_root)
    assert store.class_names == jstore.class_names
    for train in (True, False):
        assert len(store.split(train)) == len(jstore.split(train))
    assert not store.load(store.split(True).get(0, 0), "depth", True).any()
    assert not store.load(store.split(True).get(1, 0), "flow", True).any()
    jcfg, cfg = _cfg(jax_config.preset), _cfg(torch_config.preset)
    for train in (True, False):
        want = JaxMMSampler(jcfg, jstore).sample_batch(
            np.random.default_rng(9), 4, train=train)
        got = MultiModalEpisodeSampler(cfg, store).sample_batch(
            np.random.default_rng(9), 4, train=train)
        for f in ("support_labels", "query_labels"):
            w, g = getattr(want, f), getattr(got, f)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f)
        for f in ("support_clips", "query_clips"):
            for m in MODS:
                np.testing.assert_array_equal(getattr(got, f)[m],
                                              getattr(want, f)[m])


def test_synthetic_multimodal_source_matches_jax():
    jcfg, cfg = _cfg(jax_config.preset), _cfg(torch_config.preset)
    want = jax_tt_cli.SyntheticMultiModalSource(jcfg, seed=5).sample_batch(
        np.random.default_rng(1), 3, train=True)
    got = tt_cli.SyntheticMultiModalSource(cfg, seed=5).sample_batch(
        np.random.default_rng(1), 3, train=True)
    np.testing.assert_array_equal(got.support_labels, want.support_labels)
    np.testing.assert_array_equal(got.query_labels, want.query_labels)
    for m in MODS:
        np.testing.assert_array_equal(got.support_clips[m], want.support_clips[m])
        np.testing.assert_array_equal(got.query_clips[m], want.query_clips[m])


def test_extract_mfm_features_matches_jax(jax_mfm, feature_root, tmp_path):
    """The whole tree (both splits, batches of 4 and a remainder) through
    both tools: the same files, each within 1e-4·max|feature|."""
    jcfg, cfg = _cfg(jax_config.preset), _cfg(torch_config.preset)
    _, v = jax_mfm
    jstore, store = _stores(feature_root)
    n_j = jax_extract(jcfg, jstore, v, str(tmp_path / "jax"),
                      jstore.class_names, batch_size=4)
    n = extract_mfm_features(store, _port_mfm(cfg, v), str(tmp_path / "port"),
                             batch_size=4)
    assert n == n_j == N_CLASSES * (N_TRAIN + N_TEST)
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("feature.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("feature.npy"))
    for f in files:
        got, want = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert got.shape == want.shape == (T, D) and got.dtype == np.float32
        _close(got, want, what=str(f))


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_teacher_cfg(monkeypatch, argv):
    """The config the JAX teacher CLI builds from ``argv`` (read where it
    records the config, before any work)."""
    def stop(cfg):
        raise _Stop(cfg)

    monkeypatch.setattr(jax_common, "save_run_config", stop)
    with pytest.raises(_Stop) as e:
        jax_tt_cli.main(argv)
    return e.value.args[0]


@pytest.mark.parametrize("argv", [
    ["--preset", "mfm_teacher", "--feature_root", "{dir}", "--traintestlist",
     "{dir}/splits", "--split", "1", "--modalities", "rgb", "flow", "depth",
     "--trans_num", "3", "--shirt_num", "2", "--training_iterations", "32",
     "--test_iters", "32", "--num_test_tasks", "8", "--debug"],
    ["--preset", "tiny", "--dataset", "hmdb", "--feature_root", "{dir}",
     "--temp_set", "2", "3", "--trans_dropout", "0", "-lr", "1e-2", "--debug"],
])
def test_teacher_cli_config_equals_jax(monkeypatch, argv, tmp_path):
    argv = [a.format(dir=tmp_path) for a in argv]
    want = _jax_teacher_cfg(monkeypatch, argv)
    _, _, got = tt_cli.parse(argv + ["--device", "cpu"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mfm_resume_continues_the_run(tmp_path):
    """Two MFM steps in one run equal one step, a checkpoint without a
    teacher, and a resumed second step (the episode stream, optimizer,
    schedule and dropout generator continue; dropout on)."""
    cfg = _with_train(_cfg(torch_config.preset), learning_rate=1e-2,
                      sch=(2,), test_iters=(), print_freq=0, save_freq=2)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trans_dropout=0.1))
    src = tt_cli.SyntheticMultiModalSource(cfg, seed=1)

    def run(c):
        state = create_mfm_train_state(c, "cpu")
        train_loop(c, state, src, make_mfm_train_step(c),
                   make_mfm_eval_step(c), MetricsLogger(print_freq=0),
                   device="cpu")
        return state

    straight = run(cfg)
    d = str(tmp_path / "run")
    run(_with_train(cfg, training_iterations=2, checkpoint_dir=d))
    ckpt = torch.load(Path(d) / "checkpoint_2.pt", weights_only=True)
    assert "teacher_state_dict" not in ckpt and "generator" in ckpt
    resumed = run(_with_train(cfg, checkpoint_dir=d,
                              resume_from_checkpoint=True))
    assert resumed.step == 2 and resumed.episodes_seen == 4
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(1e-3)
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)


def _with_train(cfg, **kw):
    return cfg.replace(train=dataclasses.replace(cfg.train, **kw))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="queue 6"):
        tt_cli.main(["--preset", "tiny", "--fusion", "tsf", "--device", "cpu",
                     "--debug"])
    # the skeleton entries of the JAX registry (queue 5) now build
    enc = make_backbone("s3d", _cfg(torch_config.preset))
    assert type(enc).__name__ == "SkeletonEncoder" and not enc.t_tr.video_axis
    with pytest.raises(NotImplementedError, match="queue 6"):
        extract_cli.main(["--mode_extract", "mfm", "--fusion", "tsf",
                          "--preset", "tiny", "--feature_root", "x",
                          "--out", "x", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 6"):
        make_mfm(_cfg(torch_config.preset), kind="dga")


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_teacher_fixed_episode_replay_matches_jax(jax_mfm, feature_root,
                                                  tmp_path, fmt):
    """``--test_only --fixed_episode_file`` replays the same five episodes
    in both packages from the same JAX-exported ``.pt``: the same accuracy
    and CI over ``len(specs)`` tasks (the replay that used to raise)."""
    from litemkd_torch.data import (draw_episode_spec, save_fixed_episodes,
                                    save_reference_fixed_episodes)
    _, v = jax_mfm
    init = str(tmp_path / "init.pt")
    export_mfm_checkpoint(v, _cfg(jax_config.preset), init)
    _, store = _stores(feature_root)
    index = store.split(False)
    rng = np.random.default_rng(12)
    specs = [draw_episode_spec(index, WAY, SHOT, 1, rng) for _ in range(5)]
    path = str(tmp_path / "fixed.json")
    if fmt == "native":
        save_fixed_episodes(specs, path)
    else:
        save_reference_fixed_episodes(specs, index, path)
    argv = ["--test_only", "-m", init, "--preset", "tiny", "--dataset", "hmdb",
            "--feature_root", str(feature_root), "--traintestlist",
            str(feature_root / "splits"), "--way", str(WAY), "--shot",
            str(SHOT), "--query_per_class_test", "1", "--seq_len", str(T),
            "--trans_linear_in_dim", str(D), "--trans_linear_out_dim", "24",
            "--trans_num", "1", "--trans_dropout", "0", "--num_test_tasks",
            "2", "--fixed_episode_file", path]
    want = jax_tt_cli.main(argv + ["--debug"])
    got = tt_cli.main(argv + ["--device", "cpu"])
    assert got["n_tasks"] == want["n_tasks"] == 5
    for k in ("accuracy", "confidence"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    assert 0.0 < got["accuracy"] < 100.0


def test_train_teacher_cli_matches_jax(jax_mfm, feature_root, tmp_path,
                                      monkeypatch):
    """Both CLIs train 2 steps from the same JAX-exported ``.pt`` on the
    fixture tree and evaluate 8 episodes at the end: the same accuracy
    and CI. The port's checkpoint loads strictly with the exported key set,
    and ``--test_only`` on it gives the same summary in both packages."""
    jcfg = _cfg(jax_config.preset)
    _, v = jax_mfm
    init = str(tmp_path / "init.pt")
    want_sd = export_mfm_checkpoint(v, jcfg, init)
    geo = ["--preset", "tiny", "--dataset", "hmdb", "--feature_root",
           str(feature_root), "--traintestlist", str(feature_root / "splits"),
           "--way", str(WAY), "--shot", str(SHOT), "--query_per_class",
           str(QPC), "--query_per_class_test", "1", "--seq_len", str(T),
           "--trans_linear_in_dim", str(D), "--trans_linear_out_dim", "24",
           "--trans_num", "1", "--trans_dropout", "0", "--num_test_tasks",
           "8", "--sch", "100", "-lr", "1e-2"]
    train = ["--training_iterations", "4", "--test_iters", "4"]
    from litemkd_tpu.train import loop as jax_loop
    summaries = []
    real = jax_loop.run_eval
    monkeypatch.setattr(jax_loop, "run_eval", lambda *a, **k: summaries.append(
        real(*a, **k)) or summaries[-1])
    jax_tt_cli.main(geo + train + ["-m", init, "--debug"])
    ck = tmp_path / "ck"
    _, history = tt_cli.main(geo + train + ["-m", init, "-c", str(ck),
                                            "--device", "cpu"])
    assert len(history) == len(summaries) == 1
    for k in ("accuracy", "confidence", "n_tasks"):
        assert history[0][k] == pytest.approx(summaries[0][k], abs=1e-9), k
    assert 0.0 < history[0]["accuracy"] < 100.0
    saved = str(ck / "checkpoint_4.pt")
    sd = torch.load(saved, weights_only=True)["model_state_dict"]
    assert set(sd) == set(want_sd)
    fresh = make_mfm(torch_config.Config.from_dict(
        json.loads((ck / "config.json").read_text())))
    fresh.load_state_dict(sd, strict=True)
    test_only = ["--test_only", "-m", saved, "--feature_root",
                 str(feature_root), "--num_test_tasks", "8"]
    want = jax_tt_cli.main(test_only + ["--debug"])
    got = tt_cli.main(test_only + ["--device", "cpu"])
    for k in ("accuracy", "confidence", "n_tasks"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k


def test_teacher_clis_run_on_cpu_without_jax(feature_root, tmp_path):
    """A fresh interpreter trains the tiny teacher on synthetic data
    through the CLI on the CPU, evaluates its checkpoint with
    ``--test_only``, extracts the fixture tree with a teacher of the
    fixture's geometry, and ends with no JAX, flax or litemkd_tpu module
    loaded."""
    ck, out = tmp_path / "ck", tmp_path / "out"
    geo = ["--way", str(WAY), "--shot", str(SHOT), "--seq_len", str(T),
           "--trans_linear_in_dim", str(D), "--trans_linear_out_dim", "24",
           "--trans_num", "1"]
    code = (
        "import json, sys\n"
        "from litemkd_torch.cli import extract, train_teacher\n"
        f"state, _ = train_teacher.main(['--preset', 'tiny', '--dataset', "
        f"'synthetic', '--device', 'cpu', '-c', {str(ck)!r}])\n"
        f"s = train_teacher.main(['--test_only', '-m', "
        f"{str(ck / 'checkpoint_4.pt')!r}, '--device', 'cpu'])\n"
        f"n = extract.main(['--mode_extract', 'mfm', '--preset', 'tiny', "
        f"'--dataset', 'hmdb', '--feature_root', {str(feature_root)!r}, "
        f"'--traintestlist', {str(feature_root / 'splits')!r}, '--out', "
        f"{str(out)!r}, '--device', 'cpu'] + {geo!r})\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'litemkd_tpu'))\n"
        "print(json.dumps({'bad': bad, 'step': state.step, "
        "'tasks': s['n_tasks'], 'videos': n}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "bad": [], "step": 2, "tasks": 2,
        "videos": N_CLASSES * (N_TRAIN + N_TEST)}
    assert len(list(out.rglob("feature.npy"))) == N_CLASSES * (N_TRAIN + N_TEST)

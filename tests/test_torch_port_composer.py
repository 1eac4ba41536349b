"""The port's fusion composer against the JAX package: every preset's logits
from the same weights, the weights carried both ways (the port's ``.pt``
through JAX's ``load_composed_checkpoint``, and JAX params back through
``fusion_state_dict_from_jax``, bitwise), ``otam:<preset>`` through a JAX
init, one SGD step for three presets, ``extract`` on both sides, the
time shifts, and every refusal of the composer's setup.

Tiny geometry of ``tests/test_torch_port_teacher.py`` (way 3, shot 2, T 4,
D 32), fp32, dropout 0, numpy-seeded episodes of 2 episodes; presets that
index a fourth or fifth modality run with that many. The JAX side runs
un-jitted (op by op), which is quicker than a compile at this size. Each
tolerance is stated where it is used.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.models.teacher import Branch as JaxBranch
from litemkd_tpu.models.teacher import ComposedFusionTeacher as JaxComposed
from litemkd_tpu.models.teacher.composer import _apply_side_shift as jax_shift
from litemkd_tpu.ops import strm as jax_strm
from litemkd_tpu.tools.torch_import import load_composed_checkpoint
from litemkd_tpu.train import teacher_steps as jts
from litemkd_tpu.train.schedule import make_optimizer as jax_make_optimizer
from litemkd_tpu.train.steps import TrainState as JaxTrainState
import litemkd_torch.config as torch_config
from litemkd_torch.models.teacher import (Branch, ComposedFusionTeacher,
                                          FUSION_PRESETS, init_mfm_)
from litemkd_torch.models.teacher.composer import _apply_side_shift
from litemkd_torch.tools import weights
from litemkd_torch.train import (create_mfm_train_state, make_mfm,
                                 make_mfm_train_step, to_device)
from test_torch_port_backbones import _np_tree
from test_torch_port_teacher import D, SHOT, T, WAY, _cfg, _close, _episode_batch

ALL_MODS = ("rgb", "depth", "flow", "skeleton", "ir")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its tensors are tiny, and
    the suite runs several worker processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def n_modalities(kind):
    """The modalities a kind indexes: five for Five*, four for Four* and
    ThreeCombinationTRX, else three."""
    name = kind.split(":")[-1]
    if name.startswith("Five"):
        return 5
    return 4 if name.startswith(("Four", "ThreeCombinationTRX")) else 3


def configs(kind, n=None, **train):
    """(JAX config, port config) at the tiny geometry with the kind's
    modalities."""
    mods = ALL_MODS[:n or n_modalities(kind)]
    return _cfg(jax_config.preset, mods, **train), _cfg(torch_config.preset,
                                                        mods, **train)


def port_model(cfg, kind, seed=0, **kw):
    """The port's teacher of ``kind`` with random weights from ``seed``."""
    model = make_mfm(cfg, kind, **kw)
    init_mfm_(model, torch.Generator().manual_seed(seed))
    return model.eval()


def through_jax_file(model, jcfg, kind, path):
    """The port's state dict saved as a ``.pt`` and read by the JAX
    package's ``load_composed_checkpoint``: JAX variables, numpy leaves."""
    torch.save(model.state_dict(), path)
    return _np_tree(load_composed_checkpoint(str(path), jcfg, kind))


def assert_same_teacher(kind, jcfg, cfg, model, variables, seed=1, **kw):
    """The port's logits on 2 episodes within 1e-4·max|logits| of the JAX
    package's on ``variables``, with equal argmax; and
    ``fusion_state_dict_from_jax`` of those variables equal to the port's
    state dict key for key, bitwise. Returns the port's output."""
    sf, sl, qf, ql = _episode_batch(seed, 2, cfg.model.modalities)
    jm = jts.make_mfm(jcfg, kind=kind, **kw)
    want = jm.apply(variables, sf, sl, qf, False)
    b = to_device((sf, sl, qf, ql), "cpu")
    with torch.no_grad():
        got = model(b[0], b[1], b[2])
    _close(got["logits"].numpy(), want["logits"])
    np.testing.assert_array_equal(got["logits"].numpy().argmax(-1),
                                  np.asarray(want["logits"]).argmax(-1))
    back = weights.fusion_state_dict_from_jax(variables, cfg, kind)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    return got, want


@pytest.mark.parametrize("kind", sorted(FUSION_PRESETS))
def test_preset_matches_jax_through_its_file(kind, tmp_path):
    """Each composer preset: the port's weights through a ``.pt`` into the
    JAX package, the same logits, and back bitwise."""
    jcfg, cfg = configs(kind)
    model = port_model(cfg, kind)
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    assert_same_teacher(kind, jcfg, cfg, model, v)


@pytest.mark.parametrize("kind", ["otam:ThreeTRXShiftLoopTime",
                                  "otam:TwoCross", "otam:TwoCTXShuffleTime"])
def test_otam_preset_matches_jax_init(kind):
    """``otam:<preset>`` of a TRX or CTX preset has no reference class (JAX's
    importer for the preset reads a ``bracnch`` the OTAM model lacks): a
    JAX init carried into the port through ``fusion_state_dict_from_jax``
    (strict), the same logits, and no TCT parameter in the port."""
    jcfg, cfg = configs(kind)
    sf, sl, qf, _ = _episode_batch(0, 1, cfg.model.modalities)
    v = _np_tree(jts.make_mfm(jcfg, kind=kind).init(jax.random.key(0), sf, sl,
                                                    qf, False))
    model = make_mfm(cfg, kind)
    model.load_state_dict(weights.fusion_state_dict_from_jax(v, cfg, kind),
                          strict=True)
    assert not any(k.startswith("bracnch") for k in model.state_dict())
    assert_same_teacher(kind, jcfg, cfg, model.eval(), v)


@pytest.mark.parametrize("kind", [k for k in sorted(FUSION_PRESETS)
                                  if n_modalities(k) > 3])
def test_too_few_modalities_raise_in_both(kind):
    """A preset that indexes a fourth or fifth modality, with three
    configured: the composer's modality-index ValueError in both
    packages."""
    jcfg, cfg = configs(kind, n=3)
    with pytest.raises(ValueError, match="modality index"):
        make_mfm(cfg, kind)
    sf, sl, qf, _ = _episode_batch(0, 1, cfg.model.modalities)
    with pytest.raises(ValueError, match="modality index"):
        jts.make_mfm(jcfg, kind=kind).init(jax.random.key(0), sf, sl, qf, False)


@pytest.mark.parametrize("kind", ["ThreeCross", "TwoFusionBatchFusion",
                                  "ThreeTRXShuffleTime_faithful"])
def test_preset_train_step_matches_jax(kind, tmp_path, monkeypatch):
    assert_train_step_matches_jax(kind, tmp_path, monkeypatch)


def assert_train_step_matches_jax(kind, tmp_path, monkeypatch, **kw):
    """One SGD step on 2 episodes against the JAX package's
    ``make_mfm_train_step`` from the same weights (dropout 0), with the
    tolerances of ``test_train_step_matches_jax``: task_loss within 1e-5
    relative and accuracy equal; every gradient within 2e-4·max|g|; updated
    parameters within lr·2e-4·max|g| + 1e-6·max|p|. Both run in fp32 (the
    JAX package passes ``compute_dtype`` to the MFM alone). DGA2's
    enrichment has a PE dropout of 0.1 that ``trans_dropout`` does not set
    (in both packages), so both sides turn it off here."""
    jcfg, cfg = configs(kind, learning_rate=1e-2)
    model = port_model(cfg, kind, **kw)
    if kind == "dga2":
        model.mlp1.pe.drop.p = 0.0
        monkeypatch.setattr(jax_strm, "MLPMixEnrich",
                            partial(jax_strm.MLPMixEnrich, dropout=0.0))
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    sf, sl, qf, ql = _episode_batch(8, 2, cfg.model.modalities)
    jbatch = jts.EpisodeBatch(sf, sl, qf, ql)
    t = jcfg.train
    tx = jax_make_optimizer(t.optimizer, t.learning_rate, t.sch, t.sch_gamma,
                            t.tasks_per_batch)
    zero = jnp.zeros((), jnp.int32)
    jstate = JaxTrainState(step=zero, episodes_seen=zero, params=v["params"],
                           batch_stats={}, opt_state=tx.init(v["params"]),
                           rng=jax.random.key(8), tx=tx)
    jmodel = jts.make_mfm(jcfg, kind=kind, **kw)

    def loss(p):
        logits = jmodel.apply({"params": p}, sf, sl, qf, False)["logits"]
        return jnp.sum(jax.vmap(jts.sum_ce)(logits, ql) / t.tasks_per_batch)

    jgrads = _np_tree(jax.grad(loss)(v["params"]))
    new_state, jm = jts.make_mfm_train_step(jcfg, kind=kind, **kw)(jstate, jbatch)
    state = create_mfm_train_state(cfg, "cpu", kind, state_dict=model.state_dict(),
                                   **kw)
    if kind == "dga2":
        state.model.mlp1.pe.drop.p = 0.0
    m = make_mfm_train_step(cfg)(state, to_device(jbatch, "cpu"))
    assert m["task_loss"].item() == pytest.approx(float(jm["task_loss"]),
                                                  rel=1e-5)
    assert m["accuracy"].item() == float(jm["accuracy"])
    want_g = weights.fusion_state_dict_from_jax({"params": jgrads}, cfg, kind)
    want_p = weights.fusion_state_dict_from_jax(
        {"params": _np_tree(new_state.params)}, cfg, kind)
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


@pytest.mark.parametrize("kind", ["TwoCombinationTemTroShiftTRX_faithful",
                                  "ThreeTRXCombination"])
def test_extract_both_sides_matches_jax(kind, tmp_path):
    """``extract`` of 5 videos with side 0 and 1 against the JAX package's
    within 1e-4·max. TwoCombinationTemTroShiftTRX_faithful's 3-stream branch
    sits on the support side only, so its sides differ;
    ThreeTRXCombination's dump (``PRESET_EXTRACT``: m2 and m3 rolled left)
    differs from its unshifted live fusion."""
    jcfg, cfg = configs(kind)
    model = port_model(cfg, kind)
    v = through_jax_file(model, jcfg, kind, tmp_path / "k.pt")
    jm = jts.make_mfm(jcfg, batched=False, kind=kind)
    rng = np.random.default_rng(3)
    feats = {m: rng.normal(size=(5, T, D)).astype(np.float32)
             for m in cfg.model.modalities}
    tf = {m: torch.from_numpy(f) for m, f in feats.items()}
    got = {}
    for side in (0, 1):
        want = np.asarray(jm.apply(v, feats, side, method=jm.extract))
        with torch.no_grad():
            got[side] = model.extract(tf, side).numpy()
        _close(got[side], want)
    with torch.no_grad():
        live = model.fuse(tf, side=0).numpy()
    gap = (np.abs(got[0] - got[1]).max() if kind.endswith("_faithful")
           else np.abs(got[0] - live).max())
    assert gap > 1e-3 * np.abs(got[0]).max()


@pytest.mark.parametrize("spec", [("roll", 1), ("roll", -1), ("roll", 0),
                                  ("pad", 1), ("pad", -2)])
def test_side_shift_matches_jax(spec):
    """Roll and zero-pad along time, both signs: a pad shift zero-fills the
    tail for s > 0 and the head for s < 0; equal to the JAX package's."""
    x = np.random.default_rng(4).normal(size=(3, T, 5)).astype(np.float32)
    got = _apply_side_shift(torch.from_numpy(x), spec).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_shift(jnp.asarray(x), spec)))
    mode, s = spec
    if mode == "pad" and s > 0:
        assert not got[:, T - s:].any()
    elif mode == "pad":
        assert not got[:, :-s].any()


_BAD_SETUPS = {
    "extract_branches": dict(branches=(("pair", (0, 1)),),
                             extract_branches=(("pair", (0, 2)),)),
    "no branch on a side": dict(branches=(("pair", (0, 1), 0, None, (1, 0)),)),
    "modality index": dict(branches=(("pair", (0, 3)),)),
    "shared disagree": dict(branches=(("pair", (0, 1), 0, "f"),
                                      ("pair", (0, 2), 0, "f", (1, 1), 3))),
    "unknown head": dict(branches=(("pair", (0, 1)),), head="bogus"),
    "shifted multi": dict(branches=(("multi", (0, 1, 2), 1),)),
    "shifted self": dict(branches=(("self", (0,), (("pad", 1), ("pad", 0))),)),
}


@pytest.mark.parametrize("case", sorted(_BAD_SETUPS))
def test_bad_composer_setups_raise_in_both(case):
    """Every ValueError of the composer's setup (and the shifted
    multi/self branch, refused at the forward) raises in both packages."""
    kw = dict(_BAD_SETUPS[case])
    geo = dict(way=WAY, shot=SHOT, seq_len=T, in_dim=D, out_dim=24, depth=1,
               dropout=0.0)
    jkw = dict(kw, branches=tuple(JaxBranch(*b) for b in kw["branches"]))
    if "extract_branches" in kw:
        jkw["extract_branches"] = tuple(JaxBranch(*b)
                                        for b in kw["extract_branches"])
    sf, sl, qf, ql = _episode_batch(0, 1)
    with pytest.raises(ValueError):
        JaxComposed(**geo, **jkw).init(jax.random.key(0),
                                       {m: f[0] for m, f in sf.items()}, sl[0],
                                       {m: f[0] for m, f in qf.items()}, False)
    b = to_device((sf, sl, qf, ql), "cpu")
    with pytest.raises(ValueError):
        model = ComposedFusionTeacher(**geo, **dict(
            kw, branches=tuple(Branch(*s) for s in kw["branches"])))
        model(b[0], b[1], b[2])

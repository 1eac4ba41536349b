"""Serving in the port against the JAX package: the kernel wrappers as
``torch.library`` custom ops, ``cli.export`` (reference ``.pt`` files and
``torch.export`` artifacts), ``tools/aot.py`` and ``cli.demo``.

Tiny geometry, fp32 (one bf16 artifact against the eager port), weights
from the JAX init carried across with the port's converters, numpy-seeded
episodes; the JAX side runs ``tct_attention_xla`` (no Pallas). Each
tolerance is stated where it is used.
"""
import dataclasses
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.models import BatchedStudent as JaxBatchedStudent
from litemkd_tpu.tools import aot as jax_aot
from litemkd_tpu.tools import torch_export as jax_export
from litemkd_tpu.train import teacher_steps as jts
import litemkd_torch.config as torch_config
from litemkd_torch.cli import demo as demo_cli
from litemkd_torch.cli import export as export_cli
from litemkd_torch.models import BatchedStudent
from litemkd_torch.ops import batch_norm as bn
from litemkd_torch.ops import tct_attention as ta
from litemkd_torch.tools import aot
from litemkd_torch.tools import weights
from litemkd_torch.train import make_mfm

REPO = Path(__file__).resolve().parent.parent
ITERATION = 7


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _student_cfg(make, compute_dtype="float32"):
    base = make("tiny")
    return base.replace(model=dataclasses.replace(
        base.model, compute_dtype=compute_dtype, trans_dropout=0.0))


def _mfm_cfg(make):
    base = make("tiny")
    return base.replace(model=dataclasses.replace(
        base.model, trans_linear_in_dim=32, trans_linear_out_dim=24,
        trans_num=1, trans_dropout=0.0, compute_dtype="float32"))


def _port(jcfg):
    return torch_config.Config.from_dict(json.loads(jcfg.to_json()))


def _episodes(cfg, e, seed):
    rng = np.random.default_rng(seed)
    ep = cfg.episode
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = rng.integers(0, 256, (e, ep.n_support, *shape), dtype=np.uint8)
    qry = rng.integers(0, 256, (e, ep.n_queries(False), *shape), dtype=np.uint8)
    lab = np.stack([rng.permutation(np.repeat(np.arange(ep.way), ep.shot))
                    for _ in range(e)]).astype(np.int32)
    return sup, lab, qry


def _torch_episodes(sup, lab, qry):
    return (torch.from_numpy(sup), torch.from_numpy(lab).long(),
            torch.from_numpy(qry))


@pytest.fixture(scope="module")
def student(tmp_path_factory):
    """The JAX tiny fp32 student's variables, the port's config, and a run
    directory of the port holding them: ``checkpoint_7.pt`` and
    ``config.json`` (synthetic data), as ``cli.train`` writes them."""
    jcfg = _student_cfg(jax_config.preset)
    sup, lab, qry = _episodes(jcfg, 2, 0)
    variables = _np_tree(JaxBatchedStudent(jcfg).init(
        jax.random.key(0), sup, lab, qry, train=False))
    cfg = _port(jcfg)
    run = tmp_path_factory.mktemp("student_run")
    sd = weights.student_state_dict_from_jax(variables, cfg)
    torch.save({"iteration": ITERATION, "model_state_dict": sd, "step": 1},
               run / f"checkpoint_{ITERATION}.pt")
    (run / "config.json").write_text(cfg.to_json())
    return jcfg, cfg, variables, run


def _port_student(cfg, variables):
    model = BatchedStudent(cfg)
    model.load_state_dict(weights.student_state_dict_from_jax(variables, cfg),
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def scorer_artifact(student):
    """The student's scorer exported on the CPU for 2 episodes a call."""
    jcfg, cfg, variables, run = student
    path = str(run / "scorer2.litemkd")
    manifest = aot.export_serving_artifact(cfg, _port_student(cfg, variables),
                                           path, "cpu", episodes=2)
    return path, manifest


# ---------------------------------------------------------------------------
# The custom ops
# ---------------------------------------------------------------------------

def _op_cases():
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return {
        "tct_attention": (torch.ops.litemkd.tct_attention.default,
                          [t(2, 3, 4, 8), t(2, 3, 4, 8), t(2, 5, 2, 4, 8),
                           t(2, 5, 2, 4, 8)], True),
        "bn_sums": (torch.ops.litemkd.bn_sums.default, [t(50, 6)], False),
        "bn_bwd_sums": (torch.ops.litemkd.bn_bwd_sums.default,
                        [t(50, 6), t(50, 6), t(6), t(6).abs() + 0.5], False),
    }


@pytest.mark.parametrize("name", ["tct_attention", "bn_sums", "bn_bwd_sums"])
def test_op_passes_opcheck(name):
    """Schema, fake tensor, autograd registration and AOT dispatch of each
    op on the CPU (the TCT op with inputs that need a gradient too)."""
    op, args, differentiable = _op_cases()[name]
    results = [torch.library.opcheck(op, args)]
    if differentiable:
        results.append(torch.library.opcheck(
            op, [a.clone().requires_grad_(True) for a in args]))
    for res in results:
        assert set(res.values()) == {"SUCCESS"}, res


def test_wrappers_call_the_ops_and_count_no_cpu_launch():
    """Each wrapper returns its plain version's values through the op on
    the CPU, and no launch is counted there."""
    op, args, _ = _op_cases()["tct_attention"]
    before = (ta.tct_attention.launches, bn.bn_sums.launches,
              bn.bn_bwd_sums.launches)
    torch.testing.assert_close(ta.tct_attention(*args),
                               ta.tct_attention_plain(*args), rtol=0, atol=0)
    _, (x,), _ = _op_cases()["bn_sums"]
    torch.testing.assert_close(bn.bn_sums(x), bn.bn_sums_plain(x), rtol=0, atol=0)
    _, bargs, _ = _op_cases()["bn_bwd_sums"]
    torch.testing.assert_close(bn.bn_bwd_sums(*bargs), bn.bn_bwd_sums_plain(*bargs),
                               rtol=0, atol=0)
    assert (ta.tct_attention.launches, bn.bn_sums.launches,
            bn.bn_bwd_sums.launches) == before


# ---------------------------------------------------------------------------
# cli.export to reference .pt files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["student", "teacher", "mfm"])
def test_export_cli_equals_jax_exporters(kind, student, tmp_path):
    """``cli.export`` of a port checkpoint (student, ``--teacher``,
    ``--mfm``) writes the file that ``litemkd_tpu.tools.torch_export``
    writes from the same weights: equal key sets, arrays bitwise equal, the
    same ``iteration``; the file loads strictly into a fresh port module."""
    if kind == "mfm":
        jcfg = _mfm_cfg(jax_config.preset)
        cfg = _port(jcfg)
        variables = _np_tree(_jax_mfm_variables(jcfg))
        run = tmp_path / "mfm_run"
        run.mkdir()
        torch.save({"iteration": ITERATION,
                    "model_state_dict": weights.mfm_state_dict_from_jax(variables, cfg)},
                   run / f"checkpoint_{ITERATION}.pt")
        (run / "config.json").write_text(cfg.to_json())
        jax_export.export_mfm_checkpoint({"params": variables["params"]}, jcfg,
                                         str(tmp_path / "want.pt"), ITERATION)
        flags = ["--mfm"]
    else:
        jcfg, cfg, variables, run = student
        if kind == "teacher":
            jax_export.export_teacher_checkpoint({"params": variables["params"]},
                                                 jcfg, str(tmp_path / "want.pt"),
                                                 ITERATION)
            flags = ["--teacher"]
        else:
            jax_export.export_student_checkpoint(variables, jcfg,
                                                 str(tmp_path / "want.pt"), ITERATION)
            flags = []
    out = tmp_path / "got.pt"
    export_cli.main(["--ckpt", str(run / f"checkpoint_{ITERATION}.pt"), "--out",
                     str(out), "--device", "cpu"] + flags)
    want = torch.load(tmp_path / "want.pt", weights_only=True)
    got = torch.load(out, weights_only=True)
    assert got["iteration"] == want["iteration"] == ITERATION
    assert set(got["model_state_dict"]) == set(want["model_state_dict"])
    for k, v in want["model_state_dict"].items():
        g = got["model_state_dict"][k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g, v), k
    fresh = {"student": lambda: BatchedStudent(cfg),
             "mfm": lambda: make_mfm(cfg)}
    if kind in fresh:
        fresh[kind]().load_state_dict(got["model_state_dict"], strict=True)
    else:
        from litemkd_torch.cli.test import load_teacher
        load_teacher(cfg, str(out), "cpu")


def test_export_cli_refuses_a_foreign_checkpoint(student, tmp_path):
    """A student checkpoint is not an MFM one, and a head without a TCT
    has no teacher to export; a run directory means its newest checkpoint,
    and one without a checkpoint is refused."""
    _, _, _, run = student
    ckpt = str(run / f"checkpoint_{ITERATION}.pt")
    assert export_cli.checkpoint_file(str(run)) == ckpt
    with pytest.raises(FileNotFoundError, match="no checkpoint_<n>.pt"):
        export_cli.checkpoint_file(str(tmp_path))
    with pytest.raises(ValueError, match="not the state dict of the MFM"):
        export_cli.main(["--ckpt", str(run), "--out", str(tmp_path / "x.pt"),
                         "--mfm", "--device", "cpu"])
    with pytest.raises(ValueError, match="no TCT"):
        weights.teacher_export_state_dict({"classifier.distance.clsW": torch.zeros(1)})


# ---------------------------------------------------------------------------
# AOT artifacts
# ---------------------------------------------------------------------------

def test_scorer_artifact_holds_the_op_and_equals_eager_and_jax(student,
                                                              scorer_artifact):
    """The exported scorer holds exactly 2 ``litemkd.tct_attention`` nodes
    (kl, ce) and no inlined einsum; loaded back, its logits equal the eager
    port's (atol 1e-6) and JAX's ``make_serving_fn`` on the same weights
    and episodes (rtol/atol 1e-5, as tests/test_aux.py holds JAX's own
    artifact)."""
    jcfg, cfg, variables, _ = student
    path, manifest = scorer_artifact
    program, m = aot.load_program(path)
    assert m == {k: v for k, v in manifest.items() if k != "seconds"}
    assert sorted(manifest["seconds"]) == ["export", "save"]
    assert aot.op_nodes(program) == 2
    assert aot.op_nodes(program, "aten.einsum") == 0
    assert (m["kind"], m["episodes"], m["platforms"], m["device"]) == \
        ("scorer", 2, ["cpu"], "cpu")
    assert m["input_dtypes"]["support_labels"] == "int64"
    sup, lab, qry = _episodes(jcfg, 2, 11)
    scorer, _ = aot.load_serving_artifact(path, "cpu")
    got = scorer(*_torch_episodes(sup, lab, qry))
    with torch.inference_mode():
        eager = aot.make_serving_fn(cfg, _port_student(cfg, variables))(
            *_torch_episodes(sup, lab, qry))
    torch.testing.assert_close(got, eager, rtol=0, atol=1e-6)
    want = np.asarray(jax_aot.make_serving_fn(jcfg)(variables, sup, lab, qry))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_scorer_artifact_equals_eager(tmp_path):
    """The tiny student with its bf16 trunk (the preset's autocast region)
    exported on the CPU gives the eager port's logits (atol 1e-6)."""
    cfg = _student_cfg(torch_config.preset, "bfloat16")
    model = BatchedStudent(cfg)
    from litemkd_torch.models import init_student_
    init_student_(model, torch.Generator().manual_seed(4))
    path = str(tmp_path / "bf16.litemkd")
    aot.export_serving_artifact(cfg, model, path, "cpu", episodes=1)
    args = _torch_episodes(*_episodes(cfg, 1, 5))
    with torch.inference_mode():
        want = aot.make_serving_fn(cfg, model)(*args)
    got = aot.load_serving_artifact(path)[0](*args)
    assert aot.op_nodes(aot.load_program(path)[0]) == 2
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _jax_mfm_variables(jcfg):
    model = jts.make_mfm(jcfg, batched=False)
    ep, t, d = jcfg.episode, jcfg.episode.seq_len, jcfg.model.trans_linear_in_dim
    rng = np.random.default_rng(2)
    sup = {m: jnp.asarray(rng.standard_normal((ep.n_support, t, d)).astype(np.float32))
           for m in jcfg.model.modalities}
    qry = {m: jnp.asarray(rng.standard_normal((ep.n_queries(True), t, d)).astype(
        np.float32)) for m in jcfg.model.modalities}
    labels = jnp.asarray(np.repeat(np.arange(ep.way), ep.shot).astype(np.int32))
    return model.init(jax.random.key(6), sup, labels, qry, False)


def test_extract_artifact_equals_jax(tmp_path):
    """The MFM extractor exported on the CPU equals JAX's
    ``make_extract_fn`` on the same weights and features (rtol/atol 1e-5,
    as tests/test_aux.py) and launches no TCT op."""
    jcfg = _mfm_cfg(jax_config.preset)
    cfg = _port(jcfg)
    variables = _np_tree(_jax_mfm_variables(jcfg))
    model = make_mfm(cfg)
    model.load_state_dict(weights.mfm_state_dict_from_jax(variables, cfg),
                          strict=True)
    path = str(tmp_path / "extract.litemkd")
    manifest = aot.export_extract_artifact(cfg, model, path, "cpu", batch=3)
    assert (manifest["kind"], manifest["batch"]) == ("extract_mfm", 3)
    assert sorted(manifest["input_shapes"]) == sorted(cfg.model.modalities)
    assert aot.op_nodes(aot.load_program(path)[0]) == 0
    rng = np.random.default_rng(8)
    feats = {m: rng.standard_normal((3, cfg.episode.seq_len, 32)).astype(np.float32)
             for m in cfg.model.modalities}
    got = aot.load_serving_artifact(path)[0]({m: torch.from_numpy(a)
                                              for m, a in feats.items()})
    want = np.asarray(jax_aot.make_extract_fn(jcfg)(variables, feats))
    assert got.shape == (3, cfg.episode.seq_len, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_artifact_loads_without_model_code(student, scorer_artifact):
    """A fresh interpreter loads the artifact and scores an episode with
    no ``litemkd_torch.models``/``.train`` module and no JAX loaded; its
    logits are the ones this process gets."""
    jcfg, _, _, _ = student
    path, _ = scorer_artifact
    sup, lab, qry = _episodes(jcfg, 2, 13)
    want = aot.load_serving_artifact(path)[0](*_torch_episodes(sup, lab, qry))
    inputs = Path(path).with_suffix(".npz")
    np.savez(inputs, sup=sup, lab=lab, qry=qry)
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from litemkd_torch.tools.aot import load_serving_artifact\n"
        f"scorer, m = load_serving_artifact({path!r})\n"
        f"a = np.load({str(inputs)!r})\n"
        "out = scorer(torch.from_numpy(a['sup']), torch.from_numpy(a['lab']).long(),"
        " torch.from_numpy(a['qry']))\n"
        "print(json.dumps({'logits': out.tolist(), 'modules': sorted(sys.modules)}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = [m for m in res["modules"] if m.startswith(
        ("litemkd_torch.models", "litemkd_torch.train", "jax", "flax",
         "litemkd_tpu"))]
    assert loaded == []
    torch.testing.assert_close(torch.tensor(res["logits"]), want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# cli.demo
# ---------------------------------------------------------------------------

def test_demo_once_from_checkpoint_and_artifact_equals_jax(student, capsys):
    """``cli.demo --once`` from the checkpoint and from its ``cli.export
    --aot`` artifact print the same rows, whose logits are JAX's merged
    logits of the same episode (seed 0 of the synthetic source) within
    1e-4 (the rows round to 4 decimals)."""
    jcfg, _, variables, run = student
    ckpt = str(run / f"checkpoint_{ITERATION}.pt")
    artifact = str(run / "model.litemkd")
    export_cli.main(["--ckpt", ckpt, "--out", artifact, "--aot", "--aot_check",
                     "--aot_platforms", "tpu,cpu", "--device", "cpu"])
    assert "smoke check OK: logits (1, 3, 3)" in capsys.readouterr().out
    rows = demo_cli.main(["-m", ckpt, "--once", "--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out) == rows and "loaded checkpoint" in out.err
    served = demo_cli.main(["-m", artifact, "--once", "--device", "cpu"])
    assert "serving AOT artifact" in capsys.readouterr().err
    assert served == rows
    sampler = jax_common.build_sampler(jcfg, need_teacher=False)
    batch = sampler.sample_batch(np.random.default_rng(0), 1, train=False)
    want = np.asarray(jax_aot.make_serving_fn(jcfg)(
        variables, batch.support_clips, batch.support_labels,
        batch.query_clips))[0]
    np.testing.assert_allclose([r["logits"] for r in rows], want, rtol=0, atol=1e-4)
    assert [r["true"] for r in rows] == np.asarray(batch.query_labels)[0].tolist()
    assert [r["predicted"] for r in rows] == want.argmax(-1).tolist()


def test_demo_refuses_an_artifact_of_other_geometry(student, scorer_artifact,
                                                    tmp_path):
    """An artifact of 2 episodes a call, or an extractor, is refused with
    the JAX package's errors."""
    _, cfg, _, _ = student
    with pytest.raises(ValueError, match="artifact geometry mismatch: episodes=2"):
        demo_cli.build_runner(cfg, scorer_artifact[0], "cpu")
    mcfg = _mfm_cfg(torch_config.preset)
    path = str(tmp_path / "extract.litemkd")
    aot.export_extract_artifact(mcfg, make_mfm(mcfg), path, "cpu", batch=2)
    with pytest.raises(ValueError, match="'extract_mfm' artifact"):
        demo_cli.build_runner(cfg, path, "cpu")


def test_demo_http_handler_answers(student):
    """The demo's server on port 0, in a thread, answers ``/?seed=1`` with
    200 and a page naming the episode's accuracy."""
    _, cfg, _, run = student
    run_episode = demo_cli.build_runner(cfg, str(run / f"checkpoint_{ITERATION}.pt"),
                                        "cpu")
    server = demo_cli.make_server(cfg, run_episode, 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/?seed=1"
        with urllib.request.urlopen(url, timeout=60) as resp:
            status, body = resp.status, resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert status == 200
    assert "(seed 1) — accuracy" in body and 'href="/?seed=2"' in body

"""The MobileNetV3 student against the JAX package: both trunk widths'
backbones in eval and train mode with the running statistics they update,
per-block remat and ``freeze_bn``, one ``student_mobilenet`` training step
through ``run_training`` in float64, a torchvision ``mobilenet_v3`` file and
a JAX-exported student through both packages.

Weights start in the port (seeded, BatchNorm affine and statistics drawn
away from identity), go to the JAX package through its own importer
(``import_backbone_mobilenet``, ``load_student_checkpoint``) and come back
through the port's converter, which must return them exactly. JAX runs
jitted, one compile per function. Tolerances are stated where they are
used.
"""
import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.data import SyntheticEpisodeSource as JaxSource
from litemkd_tpu.models import student as jstudent
from litemkd_tpu.tools import torch_import as jimport
from litemkd_tpu.tools.torch_export import export_student_checkpoint
from litemkd_tpu.train.steps import (TrainState as JaxTrainState,
                                     make_train_step as jax_make_train_step)
import litemkd_torch.config as torch_config
from litemkd_torch.cli import common as torch_common
from litemkd_torch.cli import test as torch_test_cli
from litemkd_torch.data import SyntheticEpisodeSource
from litemkd_torch.models import BatchedStudent, BatchedTeacher, init_student_
from litemkd_torch.models import student as tstudent
from litemkd_torch.models.backbones.resnet import ResNetBackbone
from litemkd_torch.tools.weights import (load_student_checkpoint,
                                         merge_state_dict,
                                         student_state_dict_from_jax,
                                         teacher_state_dict_from_jax,
                                         teacher_state_dict_from_reference)
from litemkd_torch.train import run_training
from litemkd_torch.utils.logging import MetricsLogger
from test_torch_port_backbones import _clips, _close, _np_tree, _running_stats
from test_torch_port_expert import _CAPTURE, _x64

VARIANTS = {"mobilenetv3_large_2fc": "large", "mobilenetv3_small": "small"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: its tensors are small,
    and the suite runs several worker processes on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(config, **model):
    base = config.preset("tiny")
    model = {"compute_dtype": "float32", "trans_dropout": 0.0, **model}
    return base.replace(model=dataclasses.replace(base.model, **model))


def _seeded(model, seed):
    """``model`` with seeded weights, every BatchNorm's scale, bias and
    running statistics drawn away from identity (fp32 values)."""
    init_student_(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.5, generator=g)
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def _numpy(sd, prefix=""):
    return {k[len(prefix):]: v.numpy() for k, v in sd.items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def backbones():
    """Per entry: the seeded port backbone's state dict and the JAX
    variables that ``import_backbone_mobilenet`` makes of it; the port's
    converter gives the state dict back exactly."""
    out = {}
    for name, variant in VARIANTS.items():
        cfg = _tiny(torch_config, backbone=name)
        sd = _seeded(tstudent.make_backbone(name, cfg), 1).state_dict()
        jvars = jimport.import_backbone_mobilenet(_numpy(sd), variant)
        back = student_state_dict_from_jax(
            {"params": {"backbone": jvars["params"]},
             "batch_stats": {"backbone": jvars["batch_stats"]}}, cfg)
        assert back.keys() == {f"backbone.{k}" for k in sd}
        for k, v in sd.items():
            assert torch.equal(back[f"backbone.{k}"], v), k
        out[name] = (sd, _np_tree(jvars))
    return out


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mobilenet_backbone_matches_jax(name, backbones):
    """Each width against the JAX package's entry at 64 px (the 2×2 final
    map feeds the overlapping 4×4 adaptive max-pool): eval-mode features in
    fp32 at rtol 1e-4 and atol 1e-5·max; train-mode features (batch
    statistics, eps 1e-3) in float64 at rtol 1e-9 and atol 1e-9·max, with
    the running statistics they update (flax momentum 0.99, the biased
    variance) at rtol 1e-6 and atol 1e-6·max. Train mode is held in float64
    because in fp32 the JAX package's BatchNorm variance, E[x²]−E[x]² over
    the 16 values a channel has in the last stages, moves a feature by up to
    1.4e-5·max."""
    sd, jvars = backbones[name]
    jcfg, cfg = (_tiny(c, backbone=name) for c in (jax_config, torch_config))
    jm = jstudent.make_backbone(name, jcfg, module_name=None)
    tm = tstudent.make_backbone(name, cfg)
    tm.load_state_dict(sd, strict=True)
    clips = _clips(3, b=2, t=2, size=64)
    x = torch.from_numpy(clips)
    want = jax.jit(partial(jm.apply, train=False))(jvars, clips)
    with torch.no_grad():
        got = tm.eval()(x)
    want, got = (v if isinstance(v, dict) else {"out": v} for v in (want, got))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], name=f"eval {k}")

    jcfg, cfg = (_tiny(c, backbone=name, compute_dtype="float64")
                 for c in (jax_config, torch_config))
    with _x64():
        jm = jstudent.make_backbone(name, jcfg, module_name=None)
        want, mutated = jax.jit(partial(jm.apply, train=True,
                                        mutable=["batch_stats"]))(jvars, clips)
        want, mutated = _np_tree(want), _np_tree(mutated["batch_stats"])
    tm = tstudent.make_backbone(name, cfg)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.double().train()(x)
    want, got = (v if isinstance(v, dict) else {"out": v} for v in (want, got))
    for k in want:
        _close(got[k], want[k], rtol=1e-9, atol=1e-9, name=f"train {k}")
    stats = student_state_dict_from_jax(
        {"params": {"backbone": jvars["params"]},
         "batch_stats": {"backbone": mutated}}, cfg)
    moved = 0
    for k, v in _running_stats(stats).items():
        _close(tm.state_dict()[k[len("backbone."):]], v.numpy(), rtol=1e-6,
               atol=1e-6, name=k)
        moved += not torch.equal(v, sd[k[len("backbone."):]])
    assert moved == len(_running_stats(stats))


def _loss_and_grads(model, clips):
    model.zero_grad(set_to_none=True)
    out = model(clips)
    out = out if isinstance(out, dict) else {"out": out}
    loss = sum((v.square().mean() for v in out.values()), torch.zeros(()))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_mobilenet_remat_and_freeze_bn(name, backbones):
    """``--remat`` recomputes each inverted-residual block in the backward
    pass: one fp32 training pass with it gives the loss, every gradient and
    the running statistics of the pass without it, and each BatchNorm
    counts one update (the recompute moves no statistics); rtol 1e-5, atol
    1e-5·max (the same arithmetic, sums in another order). ``freeze_bn``
    in train mode normalises with the running statistics: the JAX eval
    features (rtol 1e-4, atol 1e-5·max), no statistic moves, and the
    gradients still reach every weight."""
    sd, jvars = backbones[name]
    jcfg = _tiny(jax_config, backbone=name)
    clips = torch.from_numpy(_clips(4, b=2, t=2, size=64))
    runs = {}
    for remat in (False, True):
        cfg = _tiny(torch_config, backbone=name, remat=remat)
        m = tstudent.make_backbone(name, cfg)
        m.load_state_dict(sd, strict=True)
        runs[remat] = (m.train(),) + _loss_and_grads(m.train(), clips)
    (plain, loss, grads), (remat, loss_r, grads_r) = runs[False], runs[True]
    torch.testing.assert_close(loss_r, loss, rtol=1e-5, atol=0)
    for n, g in grads.items():
        _close(grads_r[n], g.numpy(), rtol=1e-5, atol=1e-5, name=n)
    for k, v in plain.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1 and int(remat.state_dict()[k]) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            _close(remat.state_dict()[k], v.numpy(), rtol=1e-5, atol=1e-5, name=k)

    cfg = _tiny(torch_config, backbone=name, freeze_bn=True)
    frozen = tstudent.make_backbone(name, cfg)
    frozen.load_state_dict(sd, strict=True)
    jm = jstudent.make_backbone(name, jcfg, module_name=None)
    want = jax.jit(partial(jm.apply, train=False))(jvars, clips.numpy())
    want = want if isinstance(want, dict) else {"out": want}
    _, grads_f = _loss_and_grads(frozen.train(), clips)
    with torch.no_grad():
        got = frozen(clips)
    got = got if isinstance(got, dict) else {"out": got}
    for k in want:
        _close(got[k], want[k], name=f"freeze_bn {k}")
    for k, v in frozen.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert all(float(g.abs().max()) > 0 for n, g in grads_f.items()
               if n.endswith("weight")), "a frozen-BN weight got no gradient"


# ---------------------------------------------------------------------------
# One student_mobilenet step through run_training, float64
# ---------------------------------------------------------------------------

class _Capture(MetricsLogger):
    def __init__(self):
        super().__init__(print_freq=0)
        self.records = []

    def log(self, step, scalars, force_print=False):
        self.records.append((int(step), dict(scalars)))


def _step_cfgs():
    """The tiny ``student_mobilenet`` (mobilenetv3_large_2fc, TRX_2fcsup,
    ``fc_2_sup_dist``) at 64 px in float64, dropout off: one step of 2
    episodes, no eval. One fused chunk: the JAX package's ``lax.scan``
    over micro-batches doubles the step's compile time here (to ~75 s),
    and the chunk loop is the model-free code that
    ``tests/test_torch_port_train.py`` holds with micro-batches."""
    out = []
    for config in (jax_config, torch_config):
        base = config.preset("tiny")
        mob = config.preset("student_mobilenet")
        out.append(base.replace(
            episode=dataclasses.replace(base.episode, img_size=64),
            model=dataclasses.replace(
                base.model, compute_dtype="float64", trans_dropout=0.0,
                backbone=mob.model.backbone, classifier=mob.model.classifier),
            distill=mob.distill,
            train=dataclasses.replace(base.train, training_iterations=2,
                                      micro_batch=0, test_iters=(),
                                      learning_rate=1e-2, print_freq=0),
            data=dataclasses.replace(base.data, synthetic_noise=2.0)))
    return out


def _as_f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_student_mobilenet_step_matches_jax(tmp_path):
    """One ``run_training`` step of the tiny ``student_mobilenet`` against
    the JAX package's train step on the batch that ``run_training`` draws
    first, from the same seeded weights (the port's, through the JAX
    importer and back through the port's converter) with the frozen
    TRX_2fcsup_fixed teacher, float64 on both sides: the task loss at rel
    1e-7 (the synthetic teacher features are fp32, and the teacher's
    SupportDK sums them in fp32 in both packages); every gradient at rtol
    1e-6 and atol 1e-9·max|g|, the updated weights as w − lr·g of the JAX
    gradients (SGD) at rtol 1e-9 and atol lr·1e-6·max|g|, the running
    statistics at rtol 1e-6 and atol 1e-6·max (flax stores them in the
    fp32 of their init)."""
    jcfg, cfg = _step_cfgs()
    student = _seeded(BatchedStudent(cfg), 5)
    path = str(tmp_path / "student.pt")
    torch.save({"model_state_dict": student.state_dict()}, path)
    variables = _np_tree(jimport.load_student_checkpoint(path, jcfg))
    teacher = BatchedTeacher(cfg)
    init_student_(teacher, torch.Generator().manual_seed(6))
    t_vars = {"params": {"classifier": {"transformers": jimport.import_tct(
        _numpy(teacher.state_dict()), "classifier.transformers")}}}
    sd = student_state_dict_from_jax(variables, cfg)
    for k, v in student.state_dict().items():
        assert torch.equal(sd[k], v), k
    t_sd = teacher_state_dict_from_reference(
        teacher_state_dict_from_jax(t_vars, cfg), BatchedTeacher(cfg))

    seed = cfg.train.seed
    batch = JaxSource(jcfg, n_classes=16, seed=seed, noise=2.0).sample_batch(
        np.random.default_rng((seed, 0)), 2, train=True)
    with _x64():
        v64 = _as_f64(variables)
        params = jax.tree_util.tree_map(jnp.asarray, v64["params"])
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                               episodes_seen=jnp.zeros((), jnp.int32),
                               params=params, batch_stats=v64["batch_stats"],
                               opt_state=_CAPTURE.init(params),
                               rng=jax.random.key(1), tx=_CAPTURE)
        new, jm = jax.jit(jax_make_train_step(jcfg))(jstate, _as_f64(t_vars),
                                                     batch)
        grads = student_state_dict_from_jax(_np_tree(
            {"params": new.opt_state, "batch_stats": new.batch_stats}), cfg)
        jm = {k: float(v) for k, v in jm.items()}
    src = SyntheticEpisodeSource(cfg, n_classes=16, seed=seed, noise=2.0)
    tlog = _Capture()
    state, history = run_training(cfg, src, tlog, device="cpu",
                                  teacher_state_dict=t_sd,
                                  student_state_dict=sd)
    assert history == [] and state.step == 1
    assert [s for s, _ in tlog.records] == [1]
    assert tlog.records[0][1]["task_loss"] == pytest.approx(jm["task_loss"],
                                                            rel=1e-7)
    named = dict(state.model.named_parameters())
    got_g = {n: p.grad for n, p in named.items() if p.grad is not None}
    assert set(named) - set(got_g) == {"classifier.transformers.norm_v.weight",
                                       "classifier.transformers.norm_v.bias"}
    g_max = max(float(grads[n].abs().max()) for n in got_g)
    lr = cfg.train.learning_rate
    for n, g in got_g.items():
        np.testing.assert_allclose(g.numpy(), grads[n].numpy(), rtol=1e-6,
                                   atol=1e-9 * g_max, err_msg=n)
        np.testing.assert_allclose(
            named[n].detach().numpy(),
            (sd[n].double() - lr * grads[n].double()).numpy(), rtol=1e-9,
            atol=lr * 1e-6 * g_max, err_msg=f"updated {n}")
    for n, w in _running_stats(grads).items():
        _close(state.model.get_buffer(n), w.numpy(), rtol=1e-6, atol=1e-6,
               name=n)


# ---------------------------------------------------------------------------
# Files: torchvision's layout, a JAX-exported student
# ---------------------------------------------------------------------------

def _torchvision_file(trunk_sd, path):
    """A torchvision ``mobilenet_v3`` zoo state dict: ``features.*`` (with
    ``num_batches_tracked``) and a ``classifier.*`` head, which importers
    drop."""
    sd = {f"features.{k}": v for k, v in trunk_sd.items()}
    sd["classifier.0.weight"] = torch.zeros(4, 8)
    sd["classifier.0.bias"] = torch.zeros(4)
    torch.save(sd, path)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_torchvision_mobilenet_file_loads_like_jax(name, backbones, tmp_path):
    """A torchvision ``mobilenet_v3_{large,small}`` file warm-starts the
    trunk in both packages (``--init_checkpoint``): the port's partial state
    dict holds exactly the JAX package's imported trunk, the heads keep
    their init; the other width and a resnet zoo file raise ``ValueError``
    in both."""
    sd, _ = backbones[name]
    jcfg, cfg = (_tiny(c, backbone=name) for c in (jax_config, torch_config))
    trunk = {k[len("mobile.0."):]: v for k, v in sd.items()
             if k.startswith("mobile.0.")}
    path = str(tmp_path / "zoo.pth")
    _torchvision_file(trunk, path)
    got = load_student_checkpoint(path, cfg)
    assert got.keys() == {f"backbone.mobile.0.{k}" for k in trunk
                          if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        assert torch.equal(v, trunk[k[len("backbone.mobile.0."):]]), k
    jv = _np_tree(jimport.load_student_checkpoint(path, jcfg))
    want = backbones[name][1]
    for part in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               jv[part]["backbone"]["trunk"], want[part]["trunk"])
    model = BatchedStudent(cfg)
    fresh = model.state_dict()
    model.load_state_dict(merge_state_dict(fresh, got), strict=True)
    assert torch.equal(model.state_dict()["backbone.fc1.weight"
                                          if "2fc" in name else
                                          "backbone.fc.weight"],
                       fresh["backbone.fc1.weight" if "2fc" in name
                             else "backbone.fc.weight"])

    other = next(n for n in VARIANTS if n != name)
    ocfg, ojcfg = (_tiny(c, backbone=other) for c in (torch_config, jax_config))
    for load, c in ((load_student_checkpoint, ocfg),
                    (jimport.load_student_checkpoint, ojcfg)):
        with pytest.raises(ValueError, match="needs mobilenet_v3_"):
            load(path, c)
    r18 = str(tmp_path / "r18.pth")
    seq = ResNetBackbone(depth=18, num_fc=0).state_dict()
    tv = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
          "6": "layer3", "7": "layer4"}
    torch.save({".".join([tv[k.split(".")[1]]] + k.split(".")[2:]): v
                for k, v in seq.items()}, r18)
    for load, c in ((load_student_checkpoint, cfg),
                    (jimport.load_student_checkpoint, jcfg)):
        with pytest.raises(ValueError, match="cannot warm-start"):
            load(r18, c)


def _calibrated(model, clips):
    """``model`` with each BatchNorm's running statistics set to the batch
    statistics of ``clips`` (one train-mode pass at momentum 1): in eval
    mode the random trunk then keeps its input's signal, where statistics
    far from its activations collapse every clip to nearly the same
    features and the logits to near ties."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    with torch.no_grad():
        model.train()(clips)
    for m in bns:
        m.momentum = 0.01
    return model.eval()


def test_jax_exported_mobilenet_student_through_cli_test(tmp_path, monkeypatch):
    """A tiny fp32 ``mobilenetv3_large_2fc`` student that the JAX package's
    ``export_student_checkpoint`` wrote (``backbone.mobile.0.*``,
    ``backbone.fc1/fc2``, ``classifier.transformers.*``) loads strictly in
    the port's ``cli.test`` and gives the accuracy and CI of the JAX
    package's ``run_eval`` on the same variables and synthetic episodes (10
    tasks: a chunk of 8 and 2), abs 1e-9."""
    from litemkd_tpu.train import make_eval_step as jax_make_eval_step
    from litemkd_tpu.train import run_eval as jax_run_eval
    name = "mobilenetv3_large_2fc"
    monkeypatch.setattr(torch_common, "preset",
                        lambda n: _tiny(torch_config, backbone=name))
    jcfg = _tiny(jax_config, backbone=name).replace(data=dataclasses.replace(
        jax_config.preset("tiny").data, synthetic_noise=4.0))
    cfg = _tiny(torch_config, backbone=name)
    student = _seeded(BatchedStudent(cfg), 7)
    _calibrated(student.backbone, torch.from_numpy(_clips(8, b=6, t=4, size=32)))
    ref = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": student.state_dict()}, ref)
    variables = _np_tree(jimport.load_student_checkpoint(ref, jcfg))
    path = str(tmp_path / "exported.pt")
    export_student_checkpoint(variables, jcfg, path)

    want = jax_run_eval(jcfg, variables, jax_common.build_sampler(
        jcfg, need_teacher=False), n_tasks=10, seed=jcfg.train.seed,
        eval_step=jax.jit(jax_make_eval_step(jcfg)))
    got = torch_test_cli.main(["--preset", "tiny", "--dataset", "synthetic",
                               "--num_test_tasks", "10", "--synthetic_noise",
                               "4.0", "-m", path, "--device", "cpu"])
    assert got["n_tasks"] == want["n_tasks"] == 10
    assert 0.0 < got["accuracy"] < 100.0
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-9)

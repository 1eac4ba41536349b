"""Every ``ResNetBackbone`` entry of the registry (the resnet50 Bottleneck
trunk among them) and ``ActionRecognitionNet`` against the JAX package, in
eval and train mode, with weights moved across by the port's converters;
fp32 on both sides, tolerances stated where they are used. JAX runs
without ``jit`` here (op by op), so each op shape compiles once per process
and the resnet50 cases share their compiles. The helpers serve
``tests/test_torch_port_expert.py`` too."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from litemkd_tpu.models import student as jstudent
from litemkd_tpu.models.backbones.classifier_net import (
    ActionRecognitionNet as JaxARNet)
from litemkd_torch.models import student as tstudent
from litemkd_torch.models.backbones import ActionRecognitionNet
from litemkd_torch.tools.weights import (backbone_geometry,
                                         backbone_state_dict_from_jax,
                                         classifier_net_state_dict_from_jax)

NEW_BACKBONES = ["resnet18_student", "resnet34_student", "resnet50_student",
                 "resnet18_expert", "resnet34_expert", "resnet50_gap",
                 "resnet18_gap", "resnet50_2fc", "meta_baseline",
                 "meta_baseline_fc2"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _clips(seed, b=2, t=2, size=64):
    return np.random.default_rng(seed).integers(0, 256, (b, t, size, size, 3),
                                                dtype=np.uint8)


def _shift_bn_bias(tree, path=()):
    """Every BatchNorm bias at +3 (``tests/test_torch_port_train.py``): no
    pre-activation near a ReLU kink, where a last-bit difference between
    the frameworks flips a gradient mask."""
    if isinstance(tree, dict):
        return {k: _shift_bn_bias(v, path + (k,)) for k, v in tree.items()}
    if path[-1] == "bias" and "bn" in path[-2]:
        return tree + np.float32(3.0)
    return tree


def _close(got, want, rtol=1e-4, atol=1e-5, name=""):
    """fp32 agreement: rtol, and atol relative to max|want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _outputs(x):
    return x if isinstance(x, dict) else {"out": x}


def _running_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW_BACKBONES)
def test_backbone_entry_matches_jax(name):
    """Each new ``BACKBONES`` entry against the JAX package's entry of the
    same name, weights from the JAX init through
    ``backbone_state_dict_from_jax`` (strict): eval-mode features, and
    train-mode features (batch statistics) with the running statistics
    they update, at rtol 1e-4 and atol 1e-5·max. Depth 50 loads its 53
    BatchNorms and the ``downsample`` keys."""
    clips = _clips(1)
    jm = jstudent.BACKBONES[name](out_dim=64, compute_dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.key(2), clips, train=False))
    variables["params"] = _shift_bn_bias(variables["params"])
    depth, fc_names = backbone_geometry(name)
    tm = tstudent.BACKBONES[name](out_dim=64, compute_dtype=torch.float32)
    assert tm.fc_names == fc_names
    tm.load_state_dict(backbone_state_dict_from_jax(
        variables["params"], variables["batch_stats"], depth, fc_names),
        strict=True)
    if depth == 50:
        keys = tm.state_dict()
        assert len([k for k in keys if k.endswith("running_mean")]) == 53
        assert {"resnet.4.0.downsample.0.weight", "resnet.4.0.conv3.weight",
                "resnet.7.0.downsample.1.running_var"} <= set(keys)
    x = torch.from_numpy(clips)

    want = _outputs(jm.apply(variables, clips, train=False))
    with torch.no_grad():
        got = _outputs(tm.eval()(x))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], name=f"eval {k}")

    want, mutated = jm.apply(variables, clips, train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = _outputs(tm.train()(x))
    want = _outputs(want)
    for k in want:
        _close(got[k], want[k], name=f"train {k}")
    stats = backbone_state_dict_from_jax(
        variables["params"], _np_tree(mutated["batch_stats"]), depth, fc_names)
    for k, v in _running_stats(stats).items():
        _close(tm.state_dict()[k], v.numpy(), name=k)


@pytest.mark.parametrize("depth", [18, 50])
def test_action_recognition_net_matches_jax(depth):
    """``ActionRecognitionNet`` (the pretrain classifier) against the JAX
    package's, weights through ``classifier_net_state_dict_from_jax``
    (``convnet.*``, ``fc``): logits, GAP ``features`` and 4×4 max-pool
    ``expert_features``, in eval mode and in train mode (batch statistics),
    at rtol 1e-4 and atol 1e-5·max."""
    clips = _clips(3)
    jm = JaxARNet(num_classes=5, depth=depth, compute_dtype=jnp.float32)
    variables = _np_tree(jm.init(jax.random.key(4), clips, train=False))
    variables["params"] = _shift_bn_bias(variables["params"])
    tm = ActionRecognitionNet(5, depth=depth, compute_dtype=torch.float32)
    tm.load_state_dict(classifier_net_state_dict_from_jax(variables, depth),
                       strict=True)
    x = torch.from_numpy(clips)
    for train in (False, True):
        tm.train(train)
        for method in ("__call__", "features", "expert_features"):
            want = jm.apply(variables, clips, train=train,
                            method=None if method == "__call__" else method,
                            mutable=["batch_stats"] if train else False)
            want = want[0] if train else want
            with torch.no_grad():
                got = getattr(tm, "forward" if method == "__call__" else method)(x)
            _close(got, want, name=f"{method} train={train}")
    assert tm.expert_features(x).shape == (2, 2, 2048 if depth == 50 else 512)

"""The port's analysis tools against the JAX package's: ``max_pool_stack``,
Grad-CAM and its overlay, ``cli.flops``, ``cli.profile`` and
``cli.figures``. The same numpy-seeded inputs (and weights moved across
with ``tools/weights``) go through both; tolerances are stated at each
test. Torch on few threads, small shapes."""
import json
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import litemkd_tpu.config as jax_config
from litemkd_tpu.cli import figures as jax_figures
from litemkd_tpu.cli import flops as jax_flops
from litemkd_tpu.models import Student as JaxStudent
from litemkd_tpu.ops.pooling import max_pool_stack as jax_max_pool_stack
from litemkd_tpu.train.teacher_steps import make_pretrain_model as jax_pretrain_model
from litemkd_tpu.utils import saliency as jax_saliency
import litemkd_torch.config as torch_config
from litemkd_torch.cli import figures as torch_figures
from litemkd_torch.cli import flops as torch_flops
from litemkd_torch.cli import profile as torch_profile
from litemkd_torch.models import Student
from litemkd_torch.ops.pooling import max_pool_stack
from litemkd_torch.tools.weights import classifier_net_state_dict_from_jax
from litemkd_torch.utils import saliency

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# (a) max_pool_stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,window,strides,pad", [
    ((2, 13, 13, 4), (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((1, 8, 8, 3), (2, 2), (2, 2), ((0, 0), (0, 0))),
    ((2, 9, 7, 5), (3, 3), (1, 1), ((1, 1), (1, 1)))])
def test_max_pool_stack_forward_equals_jax(shape, window, strides, pad):
    """Bit-equal to JAX's ``max_pool_stack`` (the exact max-pool)."""
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = max_pool_stack(torch.from_numpy(x), window, strides, pad)
    want = jax_max_pool_stack(jnp.asarray(x), window, strides, pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _grads(x, window=(3, 3), strides=(2, 2), pad=((1, 1), (1, 1))):
    t = torch.from_numpy(x).requires_grad_(True)
    (max_pool_stack(t, window, strides, pad) ** 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(
        jax_max_pool_stack(v, window, strides, pad) ** 2))(jnp.asarray(x))
    return t.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("hw", [9, 12])
def test_max_pool_stack_grad_equals_jax(hw):
    """The equality-mask gradient within rtol 1e-6 of JAX's, on the general
    path (9×9) and the 3×3/s2/p1 parity path (12×12, even); on tie-free
    input both equal torch's max-pool gradient."""
    x = np.random.default_rng(hw).normal(size=(2, hw, hw, 3)).astype(np.float32)
    got, want = _grads(x)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    (F.max_pool2d(t, 3, 2, 1) ** 2).sum().backward()
    np.testing.assert_allclose(got, t.grad.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("hw,window,strides,pad", [
    (9, (3, 3), (2, 2), ((1, 1), (1, 1))),
    (12, (3, 3), (2, 2), ((1, 1), (1, 1))),
    (7, (2, 3), (1, 2), ((0, 1), (1, 0)))])
def test_max_pool_stack_ties_follow_jax(hw, window, strides, pad):
    """Tied maxima (integer-valued input): every tied position gets the
    window's whole cotangent, as in JAX (equal within rtol 1e-6), which is
    not ``F.max_pool2d``'s single-argmax gradient."""
    x = np.random.default_rng(1).integers(0, 3, size=(2, hw, hw, 3)
                                          ).astype(np.float32)
    got, want = _grads(x, window, strides, pad)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if window == (3, 3):
        t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
        (F.max_pool2d(t, 3, 2, 1) ** 2).sum().backward()
        assert not np.allclose(got, t.grad.permute(0, 2, 3, 1).numpy())
        assert got.sum() > t.grad.sum().item()


# ---------------------------------------------------------------------------
# (b), (c) Grad-CAM
# ---------------------------------------------------------------------------

N_CLASSES, IMG = 5, 96


@pytest.fixture(scope="module")
def cam_weights():
    """A JAX resnet18 ActionRecognitionNet with running statistics moved
    off identity, and its port state dict."""
    rng = np.random.default_rng(3)
    model = jax_pretrain_model(jax_config.preset("tiny"), N_CLASSES, "resnet18")
    variables = model.init(jax.random.key(0),
                           jnp.zeros((1, 1, IMG, IMG, 3), jnp.float32),
                           train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def perturb(tree, path=()):
        if isinstance(tree, dict):
            return {k: perturb(v, path + (k,)) for k, v in tree.items()}
        if path[-1] == "mean":
            return (tree + 0.1 * rng.normal(size=tree.shape)).astype(np.float32)
        return (tree * rng.uniform(0.5, 1.5, size=tree.shape)).astype(np.float32)

    variables["batch_stats"] = perturb(variables["batch_stats"])
    sd = classifier_net_state_dict_from_jax(variables, depth=18)
    images = rng.random((2, IMG, IMG, 3), dtype=np.float32)
    return variables, sd, images


def test_grad_cam_equals_jax(cam_weights):
    """``backbone_predict`` logits and ``backbone_grad_cam`` maps of the
    same resnet18 weights within atol 1e-4 of JAX's."""
    variables, sd, images = cam_weights
    want_logits = jax_saliency.backbone_predict(variables, jnp.asarray(images), 18)
    got_logits = saliency.backbone_predict(sd, images, 18)
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-4, rtol=1e-4)
    for cls in (0, 3):
        want = jax_saliency.backbone_grad_cam(variables, jnp.asarray(images), cls,
                                              N_CLASSES, 18)
        got = saliency.backbone_grad_cam(sd, images, cls, N_CLASSES, 18)
        assert got.shape == want.shape == (2, 3, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_jet_equals_matplotlib():
    """The overlay's own jet table equals matplotlib's ``colormaps["jet"]``
    (what the JAX package uses) on a dense grid and at every table edge."""
    from matplotlib import colormaps
    v = np.concatenate([np.linspace(0, 1, 20001), np.arange(257) / 256,
                        np.arange(256) / 255]).astype(np.float32)
    np.testing.assert_allclose(saliency.jet(v), colormaps["jet"](v)[..., :3],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("cam_hw,img_hw", [((3, 3), (96, 96)), ((5, 7), (40, 56)),
                                           ((7, 7), (224, 224))])
def test_cam_overlay_equals_jax(cam_hw, img_hw):
    """The uint8 overlay within 1 of JAX's (bilinear, half-pixel centres)."""
    rng = np.random.default_rng(4)
    cam = rng.random(cam_hw).astype(np.float32)
    image = rng.random((*img_hw, 3)).astype(np.float32)
    got = saliency.cam_overlay(cam, image)
    want = jax_saliency.cam_overlay(cam, image)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# (d) cli.flops
# ---------------------------------------------------------------------------

def _jax_params(name):
    cfg = jax_config.preset(name)
    ep = cfg.episode
    ctx = jnp.zeros((ep.n_support, ep.seq_len, ep.img_size, ep.img_size, 3))
    tgt = jnp.zeros((ep.n_queries(True), ep.seq_len, ep.img_size, ep.img_size, 3))
    labels = jnp.asarray(np.repeat(np.arange(ep.way), ep.shot).astype(np.int32))
    shapes = jax.eval_shape(lambda: JaxStudent(cfg).init(
        jax.random.key(0), ctx, labels, tgt, train=False))
    return jax_flops.count_params(shapes["params"])


@pytest.mark.parametrize("name", ["tiny", "student_fc2sup_dist", "expert_trx",
                                  "student_mobilenet"])
def test_flops_params_equal_jax(name):
    """Params at full width (counted under FakeTensorMode, no memory)
    equal JAX's ``count_params(variables['params'])`` exactly."""
    got = torch_flops.main(["--preset", name, "--device", "cpu"])
    assert got["params"] == _jax_params(name)


def test_flops_equal_the_analytic_count(capsys):
    """GFLOPs of ``cli.flops --preset tiny`` equal the analytic count of
    the forward: every convolution's full window (2·N·Ho·Wo·Co·Ci·k²/g),
    every linear layer's 2·rows·in·out, and the TCT's two products in each
    of the student's two calls (kl and ce), 4·Q·W·U·(S·U)·dk per call. The
    JAX package's XLA count differs (it leaves out the taps that fall on
    padding and adds elementwise work); the ratio is printed."""
    got = torch_flops.main(["--preset", "tiny", "--device", "cpu"])
    cfg = torch_config.preset("tiny")
    ep, m = cfg.episode, cfg.model
    model = Student(cfg).eval()
    count = []

    def conv_hook(mod, inp, out):
        count.append(2 * out.numel() * mod.in_channels // mod.groups
                     * math.prod(mod.kernel_size))

    def linear_hook(mod, inp, out):
        count.append(2 * out.numel() * mod.in_features)

    for mod in model.modules():
        if isinstance(mod, torch.nn.Conv2d):
            mod.register_forward_hook(conv_hook)
        elif isinstance(mod, torch.nn.Linear):
            mod.register_forward_hook(linear_hook)
    frame = (ep.seq_len, ep.img_size, ep.img_size, 3)
    with torch.no_grad():
        model(torch.zeros((ep.n_support, *frame), dtype=torch.uint8),
              torch.arange(ep.way).repeat_interleave(ep.shot),
              torch.zeros((ep.n_queries(True), *frame), dtype=torch.uint8))
    tct = sum(4 * ep.n_queries(True) * ep.way * math.comb(ep.seq_len, s)
              * ep.shot * math.comb(ep.seq_len, s) * m.trans_linear_out_dim
              for s in m.temp_set)
    want = sum(count) + 2 * tct
    assert got["gflops"] * 1e9 == pytest.approx(want, rel=1e-12)
    jax_gflops = jax_flops.main(["--preset", "tiny"])["gflops"]
    capsys.readouterr()
    with capsys.disabled():
        print(f"\n[flops] tiny: port {got['gflops']:.4f} GFLOPs (FlopCounterMode) "
              f"/ JAX {jax_gflops:.4f} (XLA cost_analysis) = "
              f"{got['gflops'] / jax_gflops:.3f}")


# ---------------------------------------------------------------------------
# (e) cli.profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["train", "eval", "teacher", "pretrain"])
def test_profile_writes_a_trace_and_a_summary(path, tmp_path, capsys):
    """Each path traces on the CPU: a Chrome trace under ``--out`` and a
    summary of op times; the student's BN-kernel path names the three
    custom ops."""
    out = tmp_path / "trace"
    buckets = torch_profile.main([
        "--preset", "tiny", "--device", "cpu", "--path", path, "--steps", "1",
        "--tasks_per_batch", "2", "--micro_batch", "0", "--batch_size", "2",
        "--pallas_bn", "--out", str(out)])
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    printed = capsys.readouterr().out
    assert "device op time:" in printed and buckets
    if path in ("train", "eval"):
        assert "litemkd::tct_attention" in buckets
    if path == "train":
        assert {"litemkd::bn_sums", "litemkd::bn_bwd_sums"} <= set(buckets)


# ---------------------------------------------------------------------------
# (f) cli.figures
# ---------------------------------------------------------------------------

def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def test_figures_grid_and_skeleton_equal_jax(tmp_path):
    """``grid`` and ``skeleton`` (a frame, ``--frame``, ``--clip``) render
    the same pixels as the JAX package's CLI."""
    rng = np.random.default_rng(5)
    for dataset, cls, video in (("ucf", "Golf", "v1"), ("hmdb", "run", "v2")):
        for modality in ("rgb", "depth"):
            d = tmp_path / "root" / dataset / f"{modality}_l8" / cls / video
            d.mkdir(parents=True)
            for i in range(2):
                Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
                                ).save(d / f"{i:05d}.jpg")
    clip = rng.normal(size=(3, 17, 3)).astype(np.float32) * 5
    np.save(tmp_path / "clip.npy", clip)
    np.save(tmp_path / "pose.npy", clip[1])
    runs = {
        "grid": ["grid", "--data_root", str(tmp_path / "root"),
                 "--row", "ucf:Golf:v1", "--row", "hmdb:run:v2",
                 "--modalities", "rgb", "depth", "--img_size", "32"],
        "pose": ["skeleton", "--npy", str(tmp_path / "pose.npy")],
        "frame": ["skeleton", "--npy", str(tmp_path / "clip.npy"), "--frame", "2"],
        "clip": ["skeleton", "--npy", str(tmp_path / "clip.npy"), "--clip"],
    }
    for name, argv in runs.items():
        ext = ".png" if name == "grid" else ".jpg"
        mine, theirs = tmp_path / f"t_{name}{ext}", tmp_path / f"j_{name}{ext}"
        torch_figures.main(argv + ["--out", str(mine)])
        jax_figures.main(argv + ["--out", str(theirs)])
        np.testing.assert_array_equal(_pixels(mine), _pixels(theirs), err_msg=name)
    with pytest.raises(SystemExit):
        torch_figures.main(["skeleton", "--npy", str(tmp_path / "pose.npy"),
                            "--clip"])


def test_figures_confusion_equals_jax(tmp_path):
    """The confusion CSV and heatmap of a per-task log equal JAX's."""
    rng = np.random.default_rng(6)
    with open(tmp_path / "tasks.jsonl", "w") as f:
        for t in range(6):
            classes = rng.choice(20, 3, replace=False)
            labels = np.repeat(classes, 2)
            f.write(json.dumps({"task": t, "accuracy": 0.5,
                                "classes": classes.tolist(),
                                "real_labels": labels.tolist(),
                                "real_preds": rng.permutation(labels).tolist()})
                    + "\n")
    for main, tag in ((torch_figures.main, "t"), (jax_figures.main, "j")):
        main(["confusion", "--log", str(tmp_path / "tasks.jsonl"),
              "--out", str(tmp_path / f"{tag}.csv"),
              "--png", str(tmp_path / f"{tag}.png")])
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    np.testing.assert_array_equal(_pixels(tmp_path / "t.png"),
                                  _pixels(tmp_path / "j.png"))


def test_figures_cam_equals_jax(cam_weights, tmp_path, capsys):
    """``cam --ckpt`` on a checkpoint of the port's pretrain layout writes
    the overlay of the port's saliency functions, which is the one the JAX
    package's saliency makes from the same weights and frame (see below for
    the bound), for the same argmax class."""
    variables, sd, _ = cam_weights
    rng = np.random.default_rng(7)
    Image.fromarray(rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)).save(
        tmp_path / "frame.jpg")
    torch.save({"iteration": 8, "model_state_dict": sd},
               tmp_path / "checkpoint_8.pt")
    torch_figures.main(["cam", "--image", str(tmp_path / "frame.jpg"),
                        "--ckpt", str(tmp_path), "--img_size", str(IMG),
                        "--out", str(tmp_path / "cam.png"), "--device", "cpu"])
    printed = capsys.readouterr().out
    img = Image.open(tmp_path / "frame.jpg").convert("RGB").resize((IMG, IMG))
    rgb = np.asarray(img, dtype=np.float32) / 255.0
    images = jnp.asarray(rgb[None])
    cls = int(np.argmax(jax_saliency.backbone_predict(variables, images, 18)[0]))
    assert f"Grad-CAM class {cls} " in printed
    cam = jax_saliency.backbone_grad_cam(variables, images, cls, N_CLASSES, 18)
    want = jax_saliency.cam_overlay(cam[0], rgb)
    got = _pixels(tmp_path / "cam.png")
    mine = saliency.cam_overlay(saliency.backbone_grad_cam(sd, rgb[None], cls)[0],
                                rgb)
    np.testing.assert_array_equal(got, mine)
    np.testing.assert_allclose(
        saliency.backbone_grad_cam(sd, rgb[None], cls), cam, atol=1e-5)
    # maps within 1e-5 (measured 6e-7) still land a value now and then on
    # the other side of one of the jet colormap's 256 steps, which moves a
    # channel by up to one step (4/255 of the range; measured: 1 value of
    # 27,648 off by 2): all within one step, at least 99.9% within 1
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 4 and (d > 1).mean() <= 1e-3

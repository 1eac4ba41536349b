"""The port's host library against the JAX package's: the clip transforms
(``data/transforms.py``, the reference's ``videotransforms/`` surface, in
both ``corrected`` modes), ``tools/shrink_dataset``, ``tools/follow_pid``
and ``tools/pipeline_bench``. Pure host code: the same PIL and numpy
inputs and the same ``random.Random`` seeds go through both copies, whose
outputs must be bitwise equal.
"""
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from litemkd_tpu.data import transforms as JT
from litemkd_tpu.tools import follow_pid as jax_follow
from litemkd_tpu.tools import shrink_dataset as jax_shrink
from litemkd_torch.data import transforms as PT
from litemkd_torch.tools import follow_pid, pipeline_bench, shrink_dataset


def _clip(kind, seed=0, n=3, h=40, w=56):
    rng = np.random.default_rng(seed)
    if kind == "vol":
        return rng.integers(0, 256, (3, n, h, w)).astype(np.float32)
    arrs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    return [Image.fromarray(a) for a in arrs] if kind == "pil" else arrs


def _canon(x):
    """Output → (type name, nested arrays) for a bitwise comparison."""
    if isinstance(x, (list, tuple)):
        return ("list", [_canon(v) for v in x])
    if isinstance(x, Image.Image):
        return ("pil " + x.mode, np.asarray(x))
    if isinstance(x, torch.Tensor):
        return ("torch " + str(x.dtype), x.numpy())
    if isinstance(x, np.ndarray):
        return ("numpy " + str(x.dtype), x)
    return (type(x).__name__, x)


def _assert_same(got, want):
    (gt, gv), (wt, wv) = _canon(got), _canon(want)
    assert gt == wt
    if gt == "list":
        assert len(gv) == len(wv)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        np.testing.assert_array_equal(gv, wv)


# name → (build(T, rng, corrected), input kinds, takes corrected)
CASES = {
    "Compose": (lambda T, r, c: T.Compose([T.CenterCrop((24, 30)),
                                           T.RandomHorizontalFlip(rng=r)]),
                ("pil", "np"), False),
    "RandomHorizontalFlip": (lambda T, r, c: T.RandomHorizontalFlip(rng=r),
                             ("pil", "np"), False),
    "Resize_short_side": (lambda T, r, c: T.Resize(32, corrected=c),
                          ("pil", "np"), True),
    "Resize_bilinear_label": (lambda T, r, c: T.Resize((20, 28), "bilinear",
                                                       corrected=c),
                              ("pil", "np"), True),
    "RandomResize": (lambda T, r, c: T.RandomResize(rng=r, corrected=c),
                     ("pil", "np"), True),
    "RandomCrop": (lambda T, r, c: T.RandomCrop((24, 30), rng=r), ("pil", "np"),
                   False),
    "CenterCrop": (lambda T, r, c: T.CenterCrop((24, 30)), ("pil", "np"), False),
    "TenCrop": (lambda T, r, c: T.TenCrop((24, 30)), ("pil", "np"), False),
    "RandomRotation": (lambda T, r, c: T.RandomRotation(10, rng=r), ("pil", "np"),
                       False),
    "ColorJitter": (lambda T, r, c: T.ColorJitter(0.4, 0.4, 0.4, 0.2, rng=r,
                                                  corrected=c), ("pil",), True),
    "ClipToTensor": (lambda T, r, c: T.ClipToTensor(), ("pil", "np"), False),
    "ClipToTensor_numpy_raw": (lambda T, r, c: T.ClipToTensor(numpy=True,
                                                              div_255=False),
                               ("np",), False),
    "ToStackedTensor": (lambda T, r, c: T.ToStackedTensor(), ("pil", "np"), False),
    "ToTensor": (lambda T, r, c: T.ToTensor(), ("vol",), False),
    "Normalize": (lambda T, r, c: T.Normalize(2.0, 3.0), ("vol",), False),
    "SpatialRandomCrop": (lambda T, r, c: T.SpatialRandomCrop((24, 30), rng=r),
                          ("vol",), False),
    "resize_clip": (lambda T, r, c: lambda clip: T.resize_clip(
        clip, (33, 21), "nearest", corrected=c), ("pil", "np"), True),
    "crop_clip": (lambda T, r, c: lambda clip: T.crop_clip(clip, 3, 5, 20, 25),
                  ("pil", "np"), False),
    "adjust_ops": (lambda T, r, c: lambda clip: [
        T.adjust_hue(T.adjust_contrast(T.adjust_saturation(
            T.adjust_brightness(im, 1.2), 0.7), 1.3), 0.2) for im in clip],
        ("pil",), False),
}


def _params():
    for name, (_, kinds, has_switch) in CASES.items():
        for kind in kinds:
            for corrected in ((False, True) if has_switch else (False,)):
                for seed in (0, 1):
                    yield pytest.param(name, kind, corrected, seed,
                                       id=f"{name}-{kind}-corrected{int(corrected)}"
                                          f"-seed{seed}")


@pytest.mark.parametrize("name,kind,corrected,seed", list(_params()))
def test_transform_equals_jax(name, kind, corrected, seed):
    """The port's transform and JAX's, built alike with ``random.Random``
    of one seed, give bitwise-equal outputs of the same types on the same
    clip, and leave their generators in the same state."""
    build = CASES[name][0]
    rng_port, rng_jax = random.Random(seed), random.Random(seed)
    got = build(PT, rng_port, corrected)(_clip(kind, seed))
    want = build(JT, rng_jax, corrected)(_clip(kind, seed))
    _assert_same(got, want)
    assert rng_port.getstate() == rng_jax.getstate()


def test_transforms_module_surface_equals_jax():
    """Every public name of JAX's module is in the port's, and the port's
    ``data`` package exports the module as JAX's does."""
    from litemkd_torch import data
    public = {n for n in vars(JT) if not n.startswith("_")}
    assert public <= set(vars(PT))
    assert data.transforms is PT and "transforms" in data.__all__
    assert PT.get_resize_sizes(40, 56, 32) == JT.get_resize_sizes(40, 56, 32)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_shrink_dataset_tree_equals_jax(tmp_path):
    """Both shrinkers turn one frame tree (videos of 3-20 frames, a stray
    file, a video with no frames) into byte-equal trees and the same count;
    the CLIs print alike."""
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    for c, n_videos in (("classA", 2), ("classB", 3)):
        for v in range(n_videos):
            d = src / c / f"vid{v}"
            d.mkdir(parents=True)
            for f in range(int(rng.integers(3, 21))):
                Image.fromarray(rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)
                                ).save(d / f"{f:05d}.jpg")
    (src / "classB" / "empty").mkdir()
    (src / "notes.txt").write_text("not a class")
    for frames in (8, 4):
        n_port = shrink_dataset.shrink(str(src), str(tmp_path / f"p{frames}"), frames)
        n_jax = jax_shrink.shrink(str(src), str(tmp_path / f"j{frames}"), frames)
        assert n_port == n_jax == 5
        got, want = _tree(tmp_path / f"p{frames}"), _tree(tmp_path / f"j{frames}")
        assert got == want and len(got) == sum(
            min(frames, len(list(v.iterdir())))
            for v in src.glob("class*/vid*"))


def test_follow_pid_runs_the_command_after_the_pid(tmp_path):
    """``follow_pid`` waits for a reaped child's pid, runs its command and
    exits with the command's code, as JAX's does; a bad command line exits
    2."""
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()
    assert not follow_pid.pid_alive(child.pid)
    assert follow_pid.pid_alive(child.pid) == jax_follow.pid_alive(child.pid)
    marker = tmp_path / "ran"
    cmd = [sys.executable, "-c",
           f"import pathlib, sys; pathlib.Path({str(marker)!r}).touch(); sys.exit(3)"]
    with pytest.raises(SystemExit) as exc:
        follow_pid.main([str(child.pid), "--"] + cmd)
    assert exc.value.code == 3 and marker.exists()
    with pytest.raises(SystemExit) as exc:
        follow_pid.main(["123"])
    assert exc.value.code == 2


def test_pipeline_bench_prints_the_rates(capsys):
    """``pipeline_bench`` at a tiny size prints JAX's lines."""
    pipeline_bench.main(["--episodes", "1", "--img", "40", "--way", "2",
                         "--shot", "1", "--frames", "2"])
    out = capsys.readouterr().out
    assert "PIL decode" in out
    assert ("native C++ decode" in out) or ("native decoder unavailable" in out)

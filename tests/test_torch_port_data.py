"""The ported real-video data path against the JAX package: frame-index
sampling, frame-tree and zip scans, clip decode (the C++ decoder and PIL,
train and test, flipped and not), the episode sampler with teacher
features, views and fixed episodes, fixed-episode files in both schemas,
the prefetcher, ``run_eval`` over fixed episodes, and two training steps
through both training CLIs from a JPEG tree against fused features that
the port's own extraction CLI wrote. Also the two repaired faults: a
DataParallel-keyed student ``.pt`` through both eval CLIs, and a checkpoint
whose generator state another device type wrote.

The data path is exact (``np.array_equal``) on the same seeds; tolerances
of the model comparisons are stated where they are used. Frames are small
JPEGs written with PIL from numpy seeds (the tree of ``tests/test_data.py``).
"""
import dataclasses
import json
import logging
import os
import shutil
import zipfile

import numpy as np
import jax
import pytest
import torch
from PIL import Image

import litemkd_tpu.config as jax_config
import litemkd_tpu.data as jdata
from litemkd_tpu import native as jnative
from litemkd_tpu.cli import common as jax_common
from litemkd_tpu.cli import gen_fixed_split as jax_gen_cli
from litemkd_tpu.cli import test as jax_test_cli
from litemkd_tpu.cli import train as jax_train_cli
from litemkd_tpu.cli.train_teacher import SyntheticMultiModalSource as JaxMMSource
from litemkd_tpu.data import video as jvideo
from litemkd_tpu.models import BatchedStudent as JaxBatchedStudent
from litemkd_tpu.tools.torch_export import (export_student_checkpoint,
                                            export_teacher_checkpoint)
from litemkd_tpu.train import make_eval_step as jax_make_eval_step
from litemkd_tpu.train import run_eval as jax_run_eval
from litemkd_tpu.train.steps import create_train_state as jax_create_state
from litemkd_tpu.utils import logging as jax_logging
import litemkd_torch.config as torch_config
import litemkd_torch.data as tdata
from litemkd_torch import native as tnative
from litemkd_torch.cli import common as torch_common
from litemkd_torch.cli import extract as torch_extract_cli
from litemkd_torch.cli import gen_fixed_split as torch_gen_cli
from litemkd_torch.cli import test as torch_test_cli
from litemkd_torch.cli import train as torch_train_cli
from litemkd_torch.cli.train_teacher import SyntheticMultiModalSource
from litemkd_torch.data import video as tvideo
from litemkd_torch.models import BatchedStudent
from litemkd_torch.tools.weights import student_state_dict_from_jax
from litemkd_torch.train import (CheckpointManager, create_train_state,
                                 make_eval_step, run_eval)
from litemkd_torch.utils import logging as torch_logging

WAY, SHOT, QPC, T, D, IMG = 3, 2, 2, 4, 64, 32
N_CLASSES, VIDS_PER_CLASS = 5, 10
N_TRAIN = 7  # per class; the rest are test videos
VIEW_VALUES = (20, 60, 100, 140)  # constant pixel value per camera view
BATCH_FIELDS = ("support_clips", "support_labels", "query_clips",
                "query_labels", "support_feats", "query_feats")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Frame tree (4, 6 or 8 frames of 40×48 a video), fused feature tree,
    split lists and a 4-camera view tree; the same tree as
    ``tests/test_data.py``, from the same seed."""
    root = tmp_path_factory.mktemp("tinyset")
    rgb = root / "rgb_l8"
    feats = root / "multi_feature"
    ann = root / "splits"
    ann.mkdir()
    rng = np.random.default_rng(0)
    train_lines, test_lines = [], []
    for c in range(N_CLASSES):
        cname = f"class{c:02d}"
        for v in range(VIDS_PER_CLASS):
            vname = f"vid_{c:02d}_{v:02d}"
            vdir = rgb / cname / vname
            vdir.mkdir(parents=True)
            for fidx in range(T + (v % 3) * 2):
                arr = rng.integers(0, 255, size=(40, 48, 3), dtype=np.uint8)
                Image.fromarray(arr).save(vdir / f"{fidx:05d}.jpg")
            fdir = feats / cname / vname
            fdir.mkdir(parents=True)
            np.save(fdir / "feature.npy",
                    rng.normal(size=(T, D)).astype(np.float32))
            (train_lines if v < N_TRAIN else test_lines).append(f"{cname}/{vname}")
    (ann / "trainlist03.txt").write_text("\n".join(train_lines) + "\n")
    (ann / "testlist03.txt").write_text("\n".join(test_lines) + "\n")
    for k in range(4):
        for c in range(N_CLASSES):
            for v in range(VIDS_PER_CLASS):
                vdir = (root / "all_view_rgb_l8" / f"Camera_{k}" /
                        f"class{c:02d}" / f"vid_{c:02d}_{v:02d}")
                vdir.mkdir(parents=True)
                arr = np.full((40, 48, 3), VIEW_VALUES[k], np.uint8)
                for fidx in range(T):
                    Image.fromarray(arr).save(vdir / f"{fidx:05d}.jpg")
    with zipfile.ZipFile(root / "frames.zip", "w") as zf:
        for dirpath, _, files in os.walk(rgb):
            for f in sorted(files):
                full = os.path.join(dirpath, f)
                zf.write(full, os.path.relpath(full, root))
    return root


def _cfg(make, **data):
    base = make("tiny")
    return base.replace(
        episode=dataclasses.replace(base.episode, way=WAY, shot=SHOT,
                                    query_per_class=QPC, query_per_class_test=1,
                                    seq_len=T, img_size=IMG),
        model=dataclasses.replace(base.model, compute_dtype="float32"),
        data=dataclasses.replace(base.data, **data))


def _stores(dataset_dir, source="dir", use_native=True, views=False):
    path = str(dataset_dir / ("frames.zip" if source == "zip" else "rgb_l8"))
    kw = dict(use_native=use_native,
              view_root=str(dataset_dir / "all_view_rgb_l8") if views else None)
    args = (path, str(dataset_dir / "splits"), 3, T, IMG)
    return jdata.VideoStore(*args, **kw), tdata.VideoStore(*args, **kw)


def _feature_stores(root, dataset_dir):
    args = (str(root), str(dataset_dir / "splits"), 3, T, D)
    return jdata.FeatureStore(*args), tdata.FeatureStore(*args)


def _assert_batches_equal(got, want):
    for f in BATCH_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, f
        else:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


def _native_or_skip():
    if not (jnative.available() and tnative.available()):
        pytest.skip("the C++ clip decoder needs g++ and libjpeg")


# ---------------------------------------------------------------------------
# Frames and clips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len", [1, 4, 8])
def test_frame_indices_equal_jax(seq_len):
    for n_frames in range(seq_len, seq_len + 20):
        for train in (True, False):
            for seed in range(4):
                jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
                np.testing.assert_array_equal(
                    tvideo.sample_frame_indices(n_frames, seq_len, train, tr),
                    jvideo.sample_frame_indices(n_frames, seq_len, train, jr))
                assert tr.random() == jr.random()   # the same draws consumed
        np.testing.assert_array_equal(
            tvideo.sample_frame_indices_aux(n_frames, seq_len),
            jvideo.sample_frame_indices_aux(n_frames, seq_len))


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_video_store_scan_equals_jax(dataset_dir, source):
    js, ts = _stores(dataset_dir, source)
    assert ts.class_names == js.class_names
    assert ts.resize_to == js.resize_to == round(IMG * 256 / 224)
    for train in (True, False):
        jidx, tidx = js.split(train), ts.split(train)
        assert tidx.classes() == jidx.classes() == list(range(N_CLASSES))
        for c in jidx.classes():
            assert [dataclasses.astuple(r) for r in tidx.videos_for_class(c)] \
                == [dataclasses.astuple(r) for r in jidx.videos_for_class(c)]
    assert len(ts.split(True)) == N_CLASSES * N_TRAIN


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("source", ["dir", "zip"])
def test_clip_loads_equal_jax(dataset_dir, source, use_native):
    """Every video of both splits, at train (seeds giving both flip
    outcomes) and at test time, through each package's VideoStore."""
    if use_native:
        _native_or_skip()
    js, ts = _stores(dataset_dir, source, use_native)
    flips = set()
    for train in (True, False):
        for c in range(N_CLASSES):
            for i, rec in enumerate(js.split(train).videos_for_class(c)):
                seed = 10 * c + i
                flips.add(np.random.default_rng(seed).random() < 0.5)
                jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
                want = js.load(rec, train, jr)
                got = ts.load(ts.split(train).get(c, i), train, tr)
                assert got.shape == (T, IMG, IMG, 3) and got.dtype == np.uint8
                np.testing.assert_array_equal(got, want, err_msg=rec.video_id)
                assert tr.random() == jr.random()
    assert flips == {False, True}
    assert tvideo.decoders_used >= {"native" if use_native else "pil"}


def test_native_decoder_equals_pil_on_identity_resize(tmp_path):
    """Shorter side 256 = resize_to: the resize is the identity in both
    decoders, so the port's C++ path, its PIL path and the JAX package's
    C++ path give the same bytes, on files and on zip-held frames, for
    both flip outcomes."""
    _native_or_skip()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        p = tmp_path / "c0" / "v0" / f"{i:05d}.jpg"
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, size=(256, 300, 3),
                                     dtype=np.uint8)).save(p, quality=95)
        paths.append(str(p))
    zp = str(tmp_path / "z.zip")
    with zipfile.ZipFile(zp, "w") as zf:
        for p in paths:
            zf.write(p, os.path.relpath(p, tmp_path))
    zstore = tvideo.ZipFrameStore(zp)
    zpaths = [os.path.relpath(p, tmp_path) for p in paths]
    idxs = np.arange(3)
    flips = set()
    for train, seed in [(False, 0)] + [(True, s) for s in range(6)]:
        def rng():
            return np.random.default_rng(seed)
        if train:
            flips.add(rng().random() < 0.5)
        pil = tvideo.load_clip(paths, idxs, img_size=224, train=train, rng=rng())
        for got in (tvideo.load_clip_native(paths, idxs, img_size=224,
                                            train=train, rng=rng()),
                    tvideo.load_clip_native(zpaths, idxs, img_size=224,
                                            train=train, rng=rng(),
                                            zip_store=zstore),
                    jvideo.load_clip_native(paths, idxs, img_size=224,
                                            train=train, rng=rng())):
            assert got is not None
            np.testing.assert_array_equal(got, pil)
    assert flips == {False, True}


def test_native_path_selected_when_available(dataset_dir, monkeypatch, capsys):
    """With the decoder built, VideoStore's default takes it, never PIL,
    and the port builds its own library under ``litemkd_torch/_build/``."""
    _native_or_skip()
    _, ts = _stores(dataset_dir)
    monkeypatch.setattr(tvideo, "load_clip", lambda *a, **k: pytest.fail(
        "PIL path used although the C++ decoder is available"))
    monkeypatch.setattr(tvideo, "decoders_used", set())
    clip = ts.load(ts.split(True).get(0, 0), True, np.random.default_rng(3))
    assert clip.shape == (T, IMG, IMG, 3)
    assert tvideo.decoders_used == {"native"}
    assert "[video] clip decoder in use: native" in capsys.readouterr().out
    lib = tnative._build()
    assert lib.parent == tnative.BUILD_DIR and lib.parent.parent.name == "litemkd_torch"
    assert lib.name.startswith("clipdec-") and lib.name.endswith(".so")


# ---------------------------------------------------------------------------
# Episodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_workers", [0, 4])
def test_episode_batches_equal_jax(dataset_dir, num_workers):
    """Clips and paired teacher features, both splits, with meta."""
    jv, tv = _stores(dataset_dir)
    jf, tf = _feature_stores(dataset_dir / "multi_feature", dataset_dir)
    js = jdata.EpisodeSampler(_cfg(jax_config.preset), jv, jf,
                              num_workers=num_workers)
    ts = tdata.EpisodeSampler(_cfg(torch_config.preset), tv, tf,
                              num_workers=num_workers)
    for train in (True, False):
        want, wmeta = js.sample_batch(np.random.default_rng(5), 3, train=train,
                                      return_meta=True)
        got, gmeta = ts.sample_batch(np.random.default_rng(5), 3, train=train,
                                     return_meta=True)
        _assert_batches_equal(got, want)
        assert got.support_clips.shape == (3, WAY * SHOT, T, IMG, IMG, 3)
        assert got.query_feats.shape == (3, WAY * (QPC if train else 1), T, D)
        for a, b in zip(gmeta, wmeta):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("data", [dict(cross_view=True, query_view=1),
                                  dict(fixed_view="Camera_2")])
def test_view_sampling_equals_jax(dataset_dir, data):
    jv, tv = _stores(dataset_dir, views=True)
    js = jdata.EpisodeSampler(_cfg(jax_config.preset, **data), jv, None,
                              num_workers=2)
    ts = tdata.EpisodeSampler(_cfg(torch_config.preset, **data), tv, None,
                              num_workers=2)
    for train in (True, False):
        want = js.sample_batch(np.random.default_rng(6), 2, train=train)
        got = ts.sample_batch(np.random.default_rng(6), 2, train=train)
        _assert_batches_equal(got, want)
    # the query clips come from the named camera (constant pixel values)
    view = 1 if "cross_view" in data else 2
    assert abs(got.query_clips.mean() - VIEW_VALUES[view]) < 5.0


def test_missing_teacher_feature_raises_in_both(dataset_dir, tmp_path):
    feat_root = tmp_path / "multi_feature"
    shutil.copytree(dataset_dir / "multi_feature", feat_root)
    shutil.rmtree(feat_root / "class00" / "vid_00_00")
    jv, tv = _stores(dataset_dir)
    jf, tf = _feature_stores(feat_root, dataset_dir)
    spec = ([0, 1, 2], [[0, 1]] * 3, [[2, 3]] * 3)   # takes vid_00_00
    for sampler, make_spec in (
            (jdata.EpisodeSampler(_cfg(jax_config.preset), jv, jf, 0),
             jdata.EpisodeSpec),
            (tdata.EpisodeSampler(_cfg(torch_config.preset), tv, tf, 0),
             tdata.EpisodeSpec)):
        with pytest.raises(FileNotFoundError, match="vid_00_00"):
            sampler.sample_batch(np.random.default_rng(0), 1, train=True,
                                 specs=[make_spec(*spec)])


def test_fixed_episode_files_between_packages(dataset_dir, tmp_path):
    """Each package reads the files the other writes (the native JSON and
    the reference's schema as JSON and as YAML), and both samplers replay
    the same specs into equal batches."""
    jv, tv = _stores(dataset_dir)
    index = tv.split(False)
    rng = np.random.default_rng(11)
    specs = [tdata.draw_episode_spec(index, WAY, SHOT, 1, rng) for _ in range(4)]
    want = [s.to_json() for s in specs]
    jspecs = [jdata.EpisodeSpec.from_json(d) for d in want]
    files = [("native.json", tdata.save_fixed_episodes, jdata.load_fixed_episodes,
              jdata.save_fixed_episodes, tdata.load_fixed_episodes, False)]
    try:
        import yaml  # noqa: F401
        ref_names = ("ref.json", "ref.yaml")
    except ImportError:
        ref_names = ("ref.json",)
    for name in ref_names:
        files.append((name, tdata.save_reference_fixed_episodes,
                      jdata.load_reference_fixed_episodes,
                      jdata.save_reference_fixed_episodes,
                      tdata.load_reference_fixed_episodes, True))
    for name, t_save, j_load, j_save, t_load, ref in files:
        path = str(tmp_path / f"port_{name}")
        t_save(specs, index, path) if ref else t_save(specs, path)
        back = j_load(path, jv.split(False)) if ref else j_load(path)
        assert [s.to_json() for s in back] == want, name
        path = str(tmp_path / f"jax_{name}")
        j_save(jspecs, jv.split(False), path) if ref else j_save(jspecs, path)
        back = t_load(path, index) if ref else t_load(path)
        assert [s.to_json() for s in back] == want, name
    js = jdata.EpisodeSampler(_cfg(jax_config.preset), jv, None, num_workers=0)
    ts = tdata.EpisodeSampler(_cfg(torch_config.preset), tv, None, num_workers=0)
    _assert_batches_equal(
        ts.sample_batch(np.random.default_rng(2), 4, train=False, specs=specs),
        js.sample_batch(np.random.default_rng(2), 4, train=False, specs=jspecs))


@pytest.mark.parametrize("fmt", ["native", "reference"])
def test_gen_fixed_split_equals_jax(dataset_dir, tmp_path, fmt):
    argv = ["--preset", "tiny", "--dataset", "hmdb", "--rgb_path",
            str(dataset_dir / "rgb_l8"), "--traintestlist",
            str(dataset_dir / "splits"), "--way", str(WAY), "--shot", str(SHOT),
            "--seq_len", str(T), "--n_episodes", "5", "--format", fmt]
    jax_gen_cli.main(argv + ["--out", str(tmp_path / "j.json")])
    torch_gen_cli.main(argv + ["--out", str(tmp_path / "t.json")])
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_synthetic_spec_replay_equals_jax():
    """The synthetic sources' nominal split and spec replay (every
    modality of the multi-modal source too)."""
    jcfg, cfg = _cfg(jax_config.preset), _cfg(torch_config.preset)
    jsrc = jdata.SyntheticEpisodeSource(jcfg, n_classes=6, seed=0)
    src = tdata.SyntheticEpisodeSource(cfg, n_classes=6, seed=0)
    assert [dataclasses.astuple(r) for r in src.split().videos_for_class(5)] == \
        [dataclasses.astuple(r) for r in jsrc.split().videos_for_class(5)]
    d = dict(classes=[0, 2, 4], support=[[0, 1], [3, 4], [5, 6]],
             query=[[2], [0], [1]])
    _assert_batches_equal(
        src.sample_batch(np.random.default_rng(1), 1, train=False,
                         specs=[tdata.EpisodeSpec.from_json(d)]),
        jsrc.sample_batch(np.random.default_rng(1), 1, train=False,
                          specs=[jdata.EpisodeSpec.from_json(d)]))
    want = JaxMMSource(jcfg, n_classes=6, seed=0).sample_batch(
        np.random.default_rng(3), 1, train=False,
        specs=[jdata.EpisodeSpec.from_json(d)])
    got = SyntheticMultiModalSource(cfg, n_classes=6, seed=0).sample_batch(
        np.random.default_rng(3), 1, train=False,
        specs=[tdata.EpisodeSpec.from_json(d)])
    for m in cfg.model.modalities:
        np.testing.assert_array_equal(got.support_clips[m], want.support_clips[m])
        np.testing.assert_array_equal(got.query_clips[m], want.query_clips[m])
    np.testing.assert_array_equal(got.query_labels, want.query_labels)


# ---------------------------------------------------------------------------
# The prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_close_drain_and_errors():
    """close() during production leaves the queue empty (a late put is
    drained by the producer on its way out); an error in ``produce`` or in
    ``transfer`` is raised in the consumer; an abandoned loop stops the
    producer; DeferredHostSync absorbs one item late and all on flush."""
    for _ in range(20):   # the race window depends on timing
        f = tdata.Prefetcher(lambda i: i + 1, 1000,
                             transfer=lambda b: b)
        it = iter(f)
        assert next(it) >= 1
        f.close()
        f.thread.join(timeout=10.0)
        assert not f.thread.is_alive()
        assert f.q.empty(), "a late put survived close()"

    def bad(i):
        if i == 2:
            raise KeyError("produce failed")
        return i

    got = []
    with pytest.raises(KeyError, match="produce failed"):
        for b in tdata.Prefetcher(bad, 5, transfer=lambda b: b * 10):
            got.append(b)
    assert got == [0, 10]
    def fail(b):
        raise ValueError("transfer failed")

    with pytest.raises(ValueError, match="transfer failed"):
        list(tdata.Prefetcher(lambda i: i, 3, transfer=fail))
    f = tdata.Prefetcher(lambda i: i, 1000, transfer=lambda b: b)
    for b in f:
        if b == 3:
            break
    f.thread.join(timeout=10.0)
    assert not f.thread.is_alive() and f.q.empty()
    assert list(tdata.Prefetcher(lambda i: None if i == 2 else i, 9,
                                 transfer=lambda b: b)) == [0, 1]

    seen = []
    sync = tdata.DeferredHostSync(lambda *item: seen.append(item))
    sync.push(1, "a")
    assert seen == []
    sync.push(2, "b")
    assert seen == [(1, "a")]
    sync.flush()
    sync.flush()
    assert seen == [(1, "a"), (2, "b")]


# ---------------------------------------------------------------------------
# The slice: run_eval over fixed episodes, then both training CLIs
# ---------------------------------------------------------------------------

def _jax_student(jcfg, sampler):
    one = sampler.sample_batch(np.random.default_rng(0), 1, train=True)
    state, t_vars = jax_create_state(jcfg, jax.random.key(3), one)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return variables, jax.tree_util.tree_map(np.asarray, t_vars)


def test_run_eval_with_specs_matches_jax(dataset_dir):
    """Six fixed episodes of the JPEG tree (a chunk of 4 and a remainder of
    2) through both run_evals on the same weights: identical per-episode
    accuracies and the same CI."""
    jv, tv = _stores(dataset_dir)
    jcfg, cfg = _cfg(jax_config.preset), _cfg(torch_config.preset)
    js = jdata.EpisodeSampler(jcfg, jv, None, num_workers=2)
    ts = tdata.EpisodeSampler(cfg, tv, None, num_workers=2)
    rng = np.random.default_rng(4)
    specs = [tdata.draw_episode_spec(tv.split(False), WAY, SHOT, 1, rng)
             for _ in range(6)]
    jspecs = [jdata.EpisodeSpec.from_json(s.to_json()) for s in specs]
    variables, _ = _jax_student(jcfg, js)
    jax_accs, torch_accs = [], []
    jstep, tstep = jax.jit(jax_make_eval_step(jcfg)), make_eval_step(cfg)

    def jax_step(v, batch):
        jax_accs.append(np.asarray(jstep(v, batch)))
        return jax_accs[-1]

    def torch_step(model, batch):
        torch_accs.append(tstep(model, batch))
        return torch_accs[-1]

    want = jax_run_eval(jcfg, variables, js, n_tasks=6, batch_size=4, seed=1,
                        eval_step=jax_step, specs=jspecs)
    model = BatchedStudent(cfg)
    model.load_state_dict(student_state_dict_from_jax(variables, cfg),
                          strict=True)
    got = run_eval(cfg, model.eval(), ts, n_tasks=6, batch_size=4, seed=1,
                   eval_step=torch_step, device=torch.device("cpu"),
                   specs=specs)
    assert [a.shape[0] for a in torch_accs] == [4, 2]
    np.testing.assert_array_equal(np.concatenate([a.numpy() for a in torch_accs]),
                                  np.concatenate(jax_accs))
    assert got["n_tasks"] == want["n_tasks"] == 6
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-9)
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-9)


def _shift_bn_bias(tree, path=()):
    """BatchNorm biases at +3 (``tests/test_torch_port_train.py``: keeps
    pre-activations off the ReLU kink, where a last-bit difference between
    the frameworks flips a mask)."""
    if isinstance(tree, dict):
        return {k: _shift_bn_bias(v, path + (k,)) for k, v in tree.items()}
    if path[-1] == "bias" and "bn" in path[-2]:
        return tree + np.float32(3.0)
    return tree


def _mfm_feature_tree(root, dataset_dir):
    """Per-modality feature trees for MFM extraction, over the videos and
    split lists of the frame tree."""
    rng = np.random.default_rng(9)
    for m in ("rgb", "depth", "flow"):
        for c in range(N_CLASSES):
            for v in range(VIDS_PER_CLASS):
                d = root / m / f"class{c:02d}" / f"vid_{c:02d}_{v:02d}"
                d.mkdir(parents=True)
                np.save(d / "feature.npy",
                        rng.normal(size=(T, D)).astype(np.float32))
    shutil.copytree(dataset_dir / "splits", root / "splits")


def test_train_clis_from_jpeg_tree_match_jax(dataset_dir, tmp_path, monkeypatch):
    """The whole slice on the CPU: the port's ``cli.extract --mode_extract
    mfm`` writes the fused tree, then both packages' ``cli.train`` take two
    steps from the JPEG tree against it, from the same exported student and
    teacher ``.pt``. The logged task losses agree at rel 1e-4, the
    tolerance of ``tests/test_torch_port_train.py::test_run_training_matches_jax``."""
    mfm_root, fused = tmp_path / "features", tmp_path / "fused"
    _mfm_feature_tree(mfm_root, dataset_dir)
    n = torch_extract_cli.main([
        "--mode_extract", "mfm", "--preset", "tiny", "--dataset", "hmdb",
        "--feature_root", str(mfm_root), "--traintestlist",
        str(mfm_root / "splits"), "--out", str(fused), "--device", "cpu"])
    assert n == N_CLASSES * VIDS_PER_CLASS
    assert np.load(next(fused.rglob("feature.npy"))).shape == (T, D)

    # fp32 compute in both packages: the CLIs build on preset("tiny")
    for common, config in ((jax_common, jax_config), (torch_common, torch_config)):
        monkeypatch.setattr(common, "preset", lambda name, c=config: _cfg(c.preset))
    jcfg = _cfg(jax_config.preset, dataset="hmdb", num_workers=0,
                rgb_path=str(dataset_dir / "rgb_l8"), teacher_path=str(fused),
                traintestlist=str(dataset_dir / "splits"))
    variables, t_vars = _jax_student(jcfg, jax_common.build_sampler(jcfg))
    variables["params"] = _shift_bn_bias(variables["params"])
    student, teacher = str(tmp_path / "s.pt"), str(tmp_path / "t.pt")
    export_student_checkpoint(variables, jcfg, student)
    export_teacher_checkpoint(t_vars, jcfg, teacher)

    records = {}
    for name, mod in (("jax", jax_logging), ("port", torch_logging)):
        monkeypatch.setattr(mod.MetricsLogger, "log",
                            lambda self, step, scalars, force_print=False, n=name:
                            records.setdefault(n, []).append((step, dict(scalars))))
    argv = ["--preset", "tiny", "--dataset", "hmdb", "--rgb_path",
            str(dataset_dir / "rgb_l8"), "--traintestlist",
            str(dataset_dir / "splits"), "--teacher_path", str(fused),
            "--init_checkpoint", student, "--teacher_checkpoint", teacher,
            "--training_iterations", "4", "--micro_batch", "1", "-lr", "1e-3",
            "--trans_dropout", "0", "--num_workers", "2", "--debug"]
    jax_train_cli.main(argv)
    torch_train_cli.main(argv + ["--device", "cpu"])
    assert [s for s, _ in records["port"]] == [s for s, _ in records["jax"]] == [1, 2]
    for (_, got), (_, want) in zip(records["port"], records["jax"]):
        assert got["episodes"] == want["episodes"]
        assert got["task_loss"] == pytest.approx(want["task_loss"], rel=1e-4)
        assert np.isfinite(got["task_loss"])


# ---------------------------------------------------------------------------
# The repaired faults
# ---------------------------------------------------------------------------

def test_module_keyed_student_loads_in_both_eval_clis(tmp_path, monkeypatch):
    """A student ``.pt`` with DataParallel ``backbone.resnet.module.*``
    keys (the reference with several GPUs) evaluates through both eval
    CLIs; the port gives the summary of the same weights without the
    ``module.`` segments, and the JAX package's matches it."""
    for common, config in ((jax_common, jax_config), (torch_common, torch_config)):
        monkeypatch.setattr(common, "preset", lambda name, c=config: _cfg(c.preset))
    cfg = _cfg(torch_config.preset)
    sd = create_train_state(cfg, "cpu").model.state_dict()
    plain, wrapped = str(tmp_path / "plain.pt"), str(tmp_path / "module.pt")
    torch.save({"model_state_dict": sd}, plain)
    torch.save({"model_state_dict": {
        k.replace("backbone.resnet.", "backbone.resnet.module."): v
        for k, v in sd.items()}}, wrapped)
    argv = ["--preset", "tiny", "--dataset", "synthetic", "--num_test_tasks",
            "4", "--synthetic_noise", "4.0"]
    want = torch_test_cli.main(argv + ["-m", plain, "--device", "cpu"])
    got = torch_test_cli.main(argv + ["-m", wrapped, "--device", "cpu"])
    assert got == want
    jax_got = jax_test_cli.main(argv + ["-m", wrapped])
    assert jax_got["n_tasks"] == 4
    assert jax_got["accuracy"] == pytest.approx(got["accuracy"], abs=1e-9)


def test_checkpoint_restores_a_foreign_generator_state(tmp_path, caplog):
    """A directory whose generator states are 16 bytes (a CUDA
    generator's) restores into a CPU train state: weights and counters
    come back, and the generators are reseeded from the seed and step,
    with a warning."""
    cfg = _cfg(torch_config.preset)
    state = create_train_state(cfg, "cpu")
    state.step, state.episodes_seen = 3, 6
    path = CheckpointManager(str(tmp_path)).save(state)
    ckpt = torch.load(path, weights_only=True)
    ckpt["generator"] = ckpt["teacher_generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(ckpt, path)
    fresh = create_train_state(cfg, "cpu")
    with caplog.at_level(logging.WARNING):
        CheckpointManager(str(tmp_path)).restore(fresh, cfg.train.seed)
    assert fresh.step == 3 and fresh.episodes_seen == 6
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert caplog.text.count("reseeded it from seed") == 2
    first = torch.rand(4, generator=fresh.generator)
    again = create_train_state(cfg, "cpu")
    CheckpointManager(str(tmp_path)).restore(again, cfg.train.seed)
    torch.testing.assert_close(torch.rand(4, generator=again.generator), first)
    assert not torch.equal(torch.rand(4, generator=again.teacher_generator),
                           torch.rand(4, generator=again.generator))

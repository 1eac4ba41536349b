"""litemkd_torch models against the JAX package on weights carried across:
the adaptive max-pool, the resnet18_2fc backbone, the BatchedStudent with
its TRX_2fcsup head and merge_logits, and the weight converter against the
JAX package's own torch exporter."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from litemkd_tpu import preset as jax_preset
from litemkd_tpu.distill import merge_logits as jax_merge_logits
from litemkd_tpu.models import BatchedStudent as JaxBatchedStudent
from litemkd_tpu.models.backbones import resnet as jres
from litemkd_tpu.tools.torch_export import export_student_checkpoint
from litemkd_torch import preset
from litemkd_torch.distill import merge_logits
from litemkd_torch.models import BatchedStudent
from litemkd_torch.models.backbones import resnet as tres
from litemkd_torch.tools.weights import (backbone_state_dict_from_jax,
                                         student_state_dict_from_jax)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fp32_tiny(make):
    base = make("tiny")
    return base.replace(model=dataclasses.replace(base.model,
                                                  compute_dtype="float32"))


def _episodes(cfg, e, seed):
    rng = np.random.default_rng(seed)
    ep = cfg.episode
    s, q = ep.way * ep.shot, ep.way * ep.query_per_class_test
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = rng.integers(0, 256, size=(e, s, *shape), dtype=np.uint8)
    qry = rng.integers(0, 256, size=(e, q, *shape), dtype=np.uint8)
    lab = np.stack([rng.permutation(np.repeat(np.arange(ep.way), ep.shot))
                    for _ in range(e)]).astype(np.int32)
    return sup, lab, qry


@pytest.fixture(scope="module")
def tiny_student():
    """A JAX tiny BatchedStudent (fp32) with its variables as numpy."""
    cfg = _fp32_tiny(jax_preset)
    sup, lab, qry = _episodes(cfg, 2, 0)
    model = JaxBatchedStudent(cfg)
    variables = model.init(jax.random.key(0), sup, lab, qry, train=False)
    return cfg, model, variables


def test_adaptive_max_pool_7_to_4_matches_jax():
    x = np.random.default_rng(0).normal(size=(3, 7, 7, 5)).astype(np.float32)
    got = tres.adaptive_max_pool_2d(torch.from_numpy(x), (4, 4)).numpy()
    want = np.asarray(jres.adaptive_max_pool_2d(jnp.asarray(x), (4, 4)))
    assert got.shape == (3, 4, 4, 5)
    np.testing.assert_array_equal(got, want)


def test_resnet18_2fc_backbone_matches_jax():
    clips = np.random.default_rng(1).integers(
        0, 256, size=(2, 2, 64, 64, 3), dtype=np.uint8)
    jm = jres.ResNetBackbone(depth=18, num_fc=2, compute_dtype=jnp.float32)
    variables = jm.init(jax.random.key(1), clips, train=False)
    want = jm.apply(variables, clips, train=False)
    tm = tres.ResNetBackbone(depth=18, num_fc=2, compute_dtype=torch.float32)
    v = _np_tree(variables)
    tm.load_state_dict(backbone_state_dict_from_jax(v["params"],
                                                    v["batch_stats"], 18),
                       strict=True)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(clips))
    for k in ("f1", "f2"):
        assert got[k].shape == (2, 2, 2048)
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_batched_student_branches_match_jax(tiny_student):
    jcfg, jm, variables = tiny_student
    sup, lab, qry = _episodes(jcfg, 2, 2)
    want = jm.apply(variables, sup, lab, qry, train=False)["logits"]
    cfg = _fp32_tiny(preset)
    tm = BatchedStudent(cfg)
    tm.load_state_dict(student_state_dict_from_jax(_np_tree(variables), cfg),
                       strict=True)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(sup), torch.from_numpy(lab).long(),
                        torch.from_numpy(qry))["logits"]
    way, q = cfg.episode.way, cfg.episode.way * cfg.episode.query_per_class_test
    shapes = {"kl": (2, q, way), "ce": (2, q, way), "sup": (2, way, way - 1)}
    assert set(got) == set(shapes)
    for k, shape in shapes.items():
        assert got[k].shape == shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        merge_logits(cfg.distill.name, got).numpy(),
        np.asarray(jax_merge_logits(jcfg.distill.name, want)),
        rtol=1e-4, atol=1e-4)


def test_weights_equal_jax_exporter_and_pt_loads_strict(tiny_student, tmp_path):
    jcfg, _, variables = tiny_student
    cfg = _fp32_tiny(preset)
    path = str(tmp_path / "student.pt")
    want = export_student_checkpoint(variables, jcfg, path, iteration=3)
    got = student_state_dict_from_jax(_np_tree(variables), cfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = BatchedStudent(cfg)
    assert set(model.state_dict()) == set(got)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)

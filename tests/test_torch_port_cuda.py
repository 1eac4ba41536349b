"""The port's CUDA kernel on the card, against its plain version. Every test
here needs a CUDA device and skips without one.

This file imports no JAX, so it runs on a machine that has only the port's
dependencies (``--noconftest`` skips the suite's JAX setup):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from litemkd_torch import preset
from litemkd_torch.ops import tct_attention as ta


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the TCT kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, device, e, q, u, dk, w, s):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
            for shape in ((e, q, u, dk), (e, q, u, dk),
                          (e, w, s, u, dk), (e, w, s, u, dk))]


@pytest.mark.cuda
@pytest.mark.parametrize("e,q,u,dk,w,s", [
    (8, 5, 28, 1152, 5, 5),     # eval chunk at the flagship width
    (4, 25, 28, 1152, 5, 5),    # training micro-batch
    (2, 3, 28, 100, 130, 1),    # ragged dk, W past 128
    (3, 11, 6, 128, 3, 2),
    (1, 1, 56, 64, 2, 5),       # U=56 (temp set 3): 32-column value slices
    (1, 2, 120, 40, 3, 1),      # U=120: 16-column slices, 4 score tiles a thread
])
def test_kernel_matches_plain(cuda_device, e, q, u, dk, w, s):
    args = _inputs(q + w, cuda_device, e, q, u, dk, w, s)
    before = ta.tct_attention.launches
    got = ta.tct_attention(*args)
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 1
    want = ta.tct_attention_plain(*args)
    assert got.shape == (e, q, w) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _inputs(0, cuda_device, 1, 2, 6, 32, 3, 2)
    with pytest.raises(TypeError):
        ta.tct_attention(*(a.double() for a in args))
    strided = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError):
        ta.tct_attention(strided, *args[1:])
    with pytest.raises(ValueError):
        ta.tct_attention(args[0].cpu(), *args[1:])


@pytest.mark.cuda
def test_student_eval_launches_kernel_twice(cuda_device):
    """A BatchedStudent forward on the card runs the TCT kernel once per
    branch (kl, ce) for the whole episode batch."""
    from litemkd_torch.cli.test import load_student
    cfg = preset("tiny")
    model = load_student(cfg, None, cuda_device)
    ep = cfg.episode
    rng = np.random.default_rng(0)
    shape = (ep.seq_len, ep.img_size, ep.img_size, 3)
    sup = torch.from_numpy(rng.integers(0, 256, (2, ep.way * ep.shot, *shape),
                                        dtype=np.uint8)).to(cuda_device)
    qry = torch.from_numpy(rng.integers(0, 256, (2, ep.way, *shape),
                                        dtype=np.uint8)).to(cuda_device)
    lab = torch.arange(ep.way, device=cuda_device).repeat_interleave(
        ep.shot).repeat(2, 1)
    before = ta.tct_attention.launches
    with torch.inference_mode():
        out = model(sup, lab, qry)["logits"]
    torch.cuda.synchronize()
    assert ta.tct_attention.launches == before + 2
    assert all(torch.isfinite(v).all() for v in out.values())

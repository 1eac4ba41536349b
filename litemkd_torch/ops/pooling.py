"""Max-pool with a scatter-free backward (port of
``litemkd_tpu/ops/pooling.py:38-137``; NOT used by the trunk, which keeps
``nn.MaxPool2d``, as the JAX package's trunk keeps ``nn.max_pool``).

:func:`max_pool_stack` keeps the exact max-pool forward and rebuilds the
gradient from an equality mask instead of the argmax scatter: the general
path adds ``g * (x_window == y)`` back onto the input grid for every window
offset, and the 3×3/stride 2/pad 1 path (the ResNet stem pool on an even
input) gathers the at most 2×2 windows of each input pixel on the four
(row, column) parity planes.

Ties: every position that equals its window's maximum gets the window's
whole cotangent (the JAX package's rule). That is not
``F.max_pool2d``'s backward, which credits one argmax. Both are valid
subgradients; ties are rare in real activations.

This is plain PyTorch on every device: the JAX package computes it in XLA
ops, not in a Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Pad2 = Tuple[Tuple[int, int], Tuple[int, int]]


def _out_size(l: int, k: int, s: int, p0: int, p1: int) -> int:
    return (l + p0 + p1 - k) // s + 1


def _forward(x, window, strides, padding):
    (ph0, ph1), (pw0, pw1) = padding
    neg = torch.finfo(x.dtype).min
    xp = F.pad(x.permute(0, 3, 1, 2), (pw0, pw1, ph0, ph1), value=neg)
    return F.max_pool2d(xp, window, strides).permute(0, 2, 3, 1)


def _bwd_3x3s2p1(x, y, g):
    """The gradient of the 3×3/s2/p1 pool on an even (H, W) grid: an even
    input row lies in one window row, an odd one in two (and the same for
    columns), so each of the four parity planes gathers from y and g
    shifted by at most one window; no scatter."""
    m, h, w, c = x.shape
    th, ts = h // 2, w // 2
    x4 = x.reshape(m, th, 2, ts, 2, c)
    xee, xeo = x4[:, :, 0, :, 0], x4[:, :, 0, :, 1]
    xoe, xoo = x4[:, :, 1, :, 0], x4[:, :, 1, :, 1]
    big = torch.finfo(x.dtype).max

    def shift_r(a, fill):
        return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], dim=1)

    def shift_c(a, fill):
        return torch.cat([a[:, :, 1:], torch.full_like(a[:, :, :1], fill)],
                         dim=2)

    y_r, g_r = shift_r(y, big), shift_r(g, 0)
    y_c, g_c = shift_c(y, big), shift_c(g, 0)
    y_rc, g_rc = shift_c(y_r, big), shift_c(g_r, 0)

    def pick(xs, ys, gs):
        return torch.where(xs == ys, gs, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))

    gee = pick(xee, y, g)
    geo = pick(xeo, y, g) + pick(xeo, y_c, g_c)
    goe = pick(xoe, y, g) + pick(xoe, y_r, g_r)
    goo = (pick(xoo, y, g) + pick(xoo, y_c, g_c)
           + pick(xoo, y_r, g_r) + pick(xoo, y_rc, g_rc))
    rows_e = torch.stack([gee, geo], dim=3)       # (m, th, ts, 2, c)
    rows_o = torch.stack([goe, goo], dim=3)
    out = torch.stack([rows_e, rows_o], dim=2)    # (m, th, 2, ts, 2, c)
    return out.reshape(m, h, w, c)


def _bwd_general(x, y, g, window, strides, padding):
    n, h, w, c = x.shape
    (ph0, ph1), (pw0, pw1) = padding
    kh, kw = window
    sh, sw = strides
    oh = _out_size(h, kh, sh, ph0, ph1)
    ow = _out_size(w, kw, sw, pw0, pw1)
    hp, wp = h + ph0 + ph1, w + pw0 + pw1
    neg = torch.finfo(x.dtype).min
    xp = F.pad(x, (0, 0, pw0, pw1, ph0, ph1), value=neg)
    gp = torch.zeros((n, hp, wp, c), dtype=g.dtype, device=g.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for di in range(kh):
        he = di + (oh - 1) * sh + 1     # slice end on the padded grid
        for dj in range(kw):
            we = dj + (ow - 1) * sw + 1
            s = xp[:, di:he:sh, dj:we:sw]
            # the strided view is the inverse of the window slice: each
            # window's term lands on the input position it was read from
            gp[:, di:he:sh, dj:we:sw] += torch.where(s == y, g, zero)
    return gp[:, ph0:hp - ph1, pw0:wp - pw1]


class _MaxPoolStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, strides, padding):
        y = _forward(x, window, strides, padding)
        ctx.save_for_backward(x, y)
        ctx.geometry = (window, strides, padding)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        window, strides, padding = ctx.geometry
        g = g.contiguous()
        if (window == (3, 3) and strides == (2, 2)
                and padding == ((1, 1), (1, 1))
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            return _bwd_3x3s2p1(x, y, g), None, None, None
        return _bwd_general(x, y, g, window, strides, padding), None, None, None


def max_pool_stack(x: torch.Tensor, window: Tuple[int, int] = (3, 3),
                   strides: Tuple[int, int] = (2, 2),
                   padding: Pad2 = ((1, 1), (1, 1))) -> torch.Tensor:
    """Max-pool a float NHWC ``x`` (static window, stride and padding, the
    padding filled with the dtype's lowest value); the forward is exact,
    the backward the equality-mask rule of the module note."""
    window, strides = tuple(window), tuple(strides)
    padding = tuple(tuple(p) for p in padding)
    return _MaxPoolStack.apply(x, window, strides, padding)

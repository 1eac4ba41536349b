"""Grad-CAM saliency for the resnet trunks (port of
``litemkd_tpu/utils/saliency.py``; the reference's ``heatmap_vis.py``,
pytorch_grad_cam over resnet layer4): the class-activation map from the
gradient of a class score with respect to the last trunk feature map,
taken with ``torch.autograd.grad`` (no hooks: the trunk's output is the
map).

The classifier is an :class:`~litemkd_torch.models.backbones.classifier_net.
ActionRecognitionNet`, the layout ``litemkd_torch.cli.pretrain`` writes
(``convnet.*``, ``fc.*``): its trunk runs in fp32 and in eval mode (the
JAX package sets ``compute_dtype=float32`` here), then the global mean
over positions and ``fc``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.backbones.classifier_net import ActionRecognitionNet

Images = Union[np.ndarray, torch.Tensor]


def _as_tensor(images: Images, device) -> torch.Tensor:
    t = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))
    return t.to(device)


def grad_cam(trunk_apply: Callable[[torch.Tensor], torch.Tensor],
             head_apply: Callable[[torch.Tensor], torch.Tensor],
             images: torch.Tensor, class_idx: int) -> np.ndarray:
    """Generic Grad-CAM: ``trunk_apply``: images → feature maps (N, h, w,
    c); ``head_apply``: feature maps → (N, n_classes) logits. Returns (N,
    h, w) maps normalized to [0, 1]."""
    with torch.enable_grad():
        fmaps = trunk_apply(images).detach().requires_grad_(True)
        score = head_apply(fmaps)[:, class_idx].sum()
        grads, = torch.autograd.grad(score, fmaps)      # (N, h, w, c)
    fmaps = fmaps.detach()
    weights = grads.mean(dim=(1, 2), keepdim=True)       # GAP over positions
    cam = torch.clamp_min((weights * fmaps).sum(dim=-1), 0.0)
    cam = cam / (cam.amax(dim=(1, 2), keepdim=True) + 1e-8)
    return cam.cpu().numpy()


def classifier_net(variables: Union[ActionRecognitionNet, Dict[str, torch.Tensor]],
                   depth: int = 18) -> ActionRecognitionNet:
    """An fp32 eval-mode ``ActionRecognitionNet``: ``variables`` itself, or
    one of ``depth`` loaded strictly from its state dict (the class count
    read from ``fc.weight``)."""
    if isinstance(variables, ActionRecognitionNet):
        return variables.float().eval()
    net = ActionRecognitionNet(int(variables["fc.weight"].shape[0]), depth=depth,
                               compute_dtype=torch.float32)
    net.load_state_dict(variables, strict=True)
    return net.to(variables["fc.weight"].device).eval()


def _trunk_and_head(variables, depth: int) -> Tuple[Callable, Callable, torch.device]:
    net = classifier_net(variables, depth)
    device = net.fc.weight.device

    def trunk_apply(x):
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        return net.convnet(x.to(torch.float32))

    def head_apply(f):
        return net.fc(f.mean(dim=(1, 2)))

    return trunk_apply, head_apply, device


def backbone_predict(variables, images: Images, depth: int = 18) -> np.ndarray:
    """(N, n_classes) logits of (N, H, W, 3) images (floats in [0, 1] or
    uint8) — the target class of Grad-CAM when none is given (the
    reference's ``target_category=None``, heatmap_vis.py:20)."""
    trunk_apply, head_apply, device = _trunk_and_head(variables, depth)
    with torch.no_grad():
        return head_apply(trunk_apply(_as_tensor(images, device))).cpu().numpy()


# matplotlib's "jet": (x, value) breakpoints of each channel, linear between
_JET = (((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
        ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0),
         (1.0, 0.0)),
        ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)))


def jet(values: np.ndarray, n: int = 256) -> np.ndarray:
    """RGB (..., 3) of values in [0, 1] through matplotlib's ``jet``
    colormap, as ``colormaps["jet"]`` maps them: a table of ``n`` colours
    sampled at i/(n-1), indexed by ⌊v·n⌋ (the top value to the last), so
    the overlay needs no matplotlib."""
    x = np.linspace(0.0, 1.0, n)
    lut = np.stack([np.interp(x, [p for p, _ in seg], [v for _, v in seg])
                    for seg in _JET], axis=-1)
    index = (np.asarray(values, np.float64) * n).astype(np.int64)
    return lut[np.clip(index, 0, n - 1)]


def cam_overlay(cam: np.ndarray, image: np.ndarray) -> np.ndarray:
    """``show_cam_on_image`` (heatmap_vis.py:46-47): the (h, w) cam resized
    bilinearly with half-pixel centres (``jax.image.resize``'s rule, with
    its antialiasing when it shrinks) to the [0, 1] float (H, W, 3) image,
    through the jet colormap (:func:`jet`), added to the image and
    renormalised by the maximum. Returns a uint8 (H, W, 3) overlay."""
    h, w = image.shape[:2]
    c = torch.from_numpy(np.asarray(cam, np.float32))[None, None]
    shrink = h < c.shape[-2] or w < c.shape[-1]
    cam_hw = F.interpolate(c, size=(h, w), mode="bilinear", align_corners=False,
                           antialias=shrink)[0, 0].numpy()
    heat = jet(np.clip(cam_hw, 0.0, 1.0))
    over = heat + image.astype(np.float32)
    over = over / max(float(over.max()), 1e-8)
    return (over * 255.0).astype(np.uint8)


def backbone_grad_cam(variables, images: Images, class_idx: int,
                      n_classes: int = None, depth: int = 18) -> np.ndarray:
    """Grad-CAM over the resnet trunk and linear probe of an
    ``ActionRecognitionNet`` (or its state dict, of ``depth``); (N, h, w)
    maps. ``n_classes`` is accepted for the JAX package's signature and
    read from the weights."""
    trunk_apply, head_apply, device = _trunk_and_head(variables, depth)
    return grad_cam(trunk_apply, head_apply, _as_tensor(images, device),
                    class_idx)

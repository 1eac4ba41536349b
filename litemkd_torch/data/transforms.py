"""Clip-transform library: the full ``videotransforms/`` surface (the
port's own copy of ``litemkd_tpu/data/transforms.py``, held equal to it by
the CPU tests).

The training/eval hot paths use the fused decode+augment in ``data/video.py``
(and ``native/clipdec.cpp``); this module rebuilds the reference's *library*
surface — every transform class a reference user could import from
``videotransforms.{video,volume,tensor,stack}_transforms`` — so downstream
code written against that API has a drop-in home here. Host-side by design:
these run on PIL images / numpy arrays during episode assembly, exactly like
the reference (the device side only ever sees the uint8 NHWC product).

Clips are lists of PIL Images or ``(H, W, C)`` numpy arrays, as in the
reference. Random transforms draw from an injectable ``rng``
(``random.Random`` or the ``random`` module, the reference's implicit
default) so episode assembly stays seed-deterministic.

Reference quirks reproduced or documented (each cited at the class):

- ``resize_clip`` maps ``interpolation='bilinear'`` to PIL **NEAREST** and
  everything else to **BILINEAR** (videotransforms/functional.py:55-58) — the
  labels are swapped, so the main path's default ``'nearest'`` has always
  meant bilinear. We keep the released mapping (``corrected=True`` un-swaps)
  because every reference checkpoint was trained under it; ``data/video.py``
  matches its *effective* behavior.
- ``ColorJitter`` builds a shuffled list of jitter ops but applies each to
  the ORIGINAL image, keeping only the last result
  (video_transforms.py:394-398) — one random jitter per clip, not four.
  Faithful by default; ``corrected=True`` chains them.
- ``SpatialRandomCrop`` slices width with the HEIGHT extent
  (``x1:x1 + h``, tensor_transforms.py:58) — crops are square-ish and can
  overrun. Fixed here (crash/garbage class, like the teacher-split scan);
  the released slice is not replicable without corrupting data.
- ``RandomRotation`` on numpy clips called the long-removed
  ``scipy.misc.imrotate`` (video_transforms.py:194) — dead at runtime; we
  rotate via PIL for both input kinds.
"""
from __future__ import annotations

import numbers
import random as _random_module
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

try:  # PIL ships with the image; keep feature-only flows import-safe
    from PIL import Image, ImageEnhance
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


def _is_numpy_clip(clip) -> bool:
    return isinstance(clip[0], np.ndarray)


def _is_pil_clip(clip) -> bool:
    return _HAVE_PIL and isinstance(clip[0], Image.Image)


def _clip_hw(clip) -> Tuple[int, int]:
    if _is_numpy_clip(clip):
        return clip[0].shape[0], clip[0].shape[1]
    if _is_pil_clip(clip):
        w, h = clip[0].size
        return h, w
    raise TypeError("Expected numpy.ndarray or PIL.Image but got list of "
                    f"{type(clip[0])}")


def _pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return (int(size), int(size))
    return (int(size[0]), int(size[1]))


def get_resize_sizes(im_h: int, im_w: int, size: int) -> Tuple[int, int]:
    """Shorter-side target dims (videotransforms/functional.py:66-73)."""
    if im_w < im_h:
        return int(size * im_h / im_w), size
    return size, int(size * im_w / im_h)


def crop_clip(clip, min_h: int, min_w: int, h: int, w: int):
    """Crop every frame at the same box (videotransforms/functional.py:10-21)."""
    if _is_numpy_clip(clip):
        return [img[min_h:min_h + h, min_w:min_w + w, :] for img in clip]
    if _is_pil_clip(clip):
        return [img.crop((min_w, min_h, min_w + w, min_h + h)) for img in clip]
    raise TypeError("Expected numpy.ndarray or PIL.Image but got list of "
                    f"{type(clip[0])}")


def resize_clip(clip, size, interpolation: str = "bilinear", *,
                corrected: bool = False):
    """Resize every frame (videotransforms/functional.py:24-63).

    ``size`` as a number = shorter-side resize (skipped when the shorter side
    already matches); as ``(h, w)`` = exact dims. The released interpolation
    mapping is SWAPPED — ``'bilinear'`` selects NEAREST and anything else
    BILINEAR; kept faithful unless ``corrected``, and the default matches the
    reference signature's ``'bilinear'`` (functional.py:24), i.e. NEAREST.
    Numpy clips (a ``NotImplementedError`` in the release) round-trip
    through PIL.
    """
    was_numpy = _is_numpy_clip(clip)
    if was_numpy:
        pil = [Image.fromarray(np.ascontiguousarray(img)) for img in clip]
    elif _is_pil_clip(clip):
        pil = clip
    else:
        raise TypeError("Expected numpy.ndarray or PIL.Image but got list of "
                        f"{type(clip[0])}")

    if isinstance(size, numbers.Number):
        im_w, im_h = pil[0].size
        if (im_w <= im_h and im_w == size) or (im_h <= im_w and im_h == size):
            return clip
        new_h, new_w = get_resize_sizes(im_h, im_w, int(size))
        target = (new_w, new_h)
    else:  # reference takes (h, w) here and flips to PIL's (w, h)
        target = (int(size[1]), int(size[0]))

    wants_bilinear = (interpolation == "bilinear")
    if corrected:
        pil_inter = Image.BILINEAR if wants_bilinear else Image.NEAREST
    else:  # released mapping, functional.py:55-58
        pil_inter = Image.NEAREST if wants_bilinear else Image.BILINEAR
    scaled = [img.resize(target, pil_inter) for img in pil]
    if was_numpy:
        return [np.asarray(img) for img in scaled]
    return scaled


class Compose:
    """Apply transforms in sequence (video_transforms.py:15-29)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip


class RandomHorizontalFlip:
    """Flip the whole clip with p=0.5 (video_transforms.py:32-56)."""

    def __init__(self, rng=None):
        self.rng = rng or _random_module

    def __call__(self, clip):
        if self.rng.random() < 0.5:
            if _is_numpy_clip(clip):
                return [np.fliplr(img) for img in clip]
            if _is_pil_clip(clip):
                return [img.transpose(Image.FLIP_LEFT_RIGHT) for img in clip]
            raise TypeError("Expected numpy.ndarray or PIL.Image but got "
                            f"list of {type(clip[0])}")
        return clip


class Resize:
    """Fixed-size / shorter-side resize (video_transforms.py:91-110)."""

    def __init__(self, size, interpolation: str = "nearest", *,
                 corrected: bool = False):
        self.size = size
        self.interpolation = interpolation
        self.corrected = corrected

    def __call__(self, clip):
        return resize_clip(clip, self.size, self.interpolation,
                           corrected=self.corrected)


class RandomResize:
    """Uniformly scale H and W by one factor (video_transforms.py:59-88)."""

    def __init__(self, ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
                 interpolation: str = "nearest", rng=None, *,
                 corrected: bool = False):
        self.ratio = ratio
        self.interpolation = interpolation
        self.corrected = corrected
        self.rng = rng or _random_module

    def __call__(self, clip):
        scale = self.rng.uniform(self.ratio[0], self.ratio[1])
        im_h, im_w = _clip_hw(clip)
        # reference computes (w, h) then passes it where resize_clip expects
        # (h, w); both dims share one scale so the swap only transposes
        # non-square frames — kept faithful (video_transforms.py:83-87)
        new_w, new_h = int(im_w * scale), int(im_h * scale)
        return resize_clip(clip, (new_w, new_h), self.interpolation,
                           corrected=self.corrected)


def _check_crop(im_h: int, im_w: int, h: int, w: int) -> None:
    if w > im_w or h > im_h:
        raise ValueError(
            "Initial image size should be larger then cropped size but got "
            f"cropped sizes : ({w}, {h}) while initial image is "
            f"({im_w}, {im_h})")


class RandomCrop:
    """Same random crop box for every frame (video_transforms.py:113-156)."""

    def __init__(self, size, rng=None):
        self.size = _pair(size)
        self.rng = rng or _random_module

    def __call__(self, clip):
        h, w = self.size
        im_h, im_w = _clip_hw(clip)
        _check_crop(im_h, im_w, h, w)
        x1 = self.rng.randint(0, im_w - w)  # x drawn before y, as released
        y1 = self.rng.randint(0, im_h - h)
        return crop_clip(clip, y1, x1, h, w)


class CenterCrop:
    """Center crop (video_transforms.py:204-247)."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, clip):
        h, w = self.size
        im_h, im_w = _clip_hw(clip)
        _check_crop(im_h, im_w, h, w)
        x1 = int(round((im_w - w) / 2.0))
        y1 = int(round((im_h - h) / 2.0))
        return crop_clip(clip, y1, x1, h, w)


class TenCrop:
    """Center + 4 corners, then the same five of the flipped clip — a list
    of 10 clips, center first (video_transforms.py:249-318)."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, clip):
        h, w = self.size
        im_h, im_w = _clip_hw(clip)
        _check_crop(im_h, im_w, h, w)
        if _is_numpy_clip(clip):
            flipped = [np.fliplr(img) for img in clip]
        else:
            flipped = [img.transpose(Image.FLIP_LEFT_RIGHT) for img in clip]
        cx = int(round((im_w - w) / 2.0))
        cy = int(round((im_h - h) / 2.0))
        boxes = [(cx, cy), (0, 0), (im_w - w, 0), (0, im_h - h),
                 (im_w - w, im_h - h)]
        crops = [crop_clip(clip, y, x, h, w) for x, y in boxes]
        crops.extend(crop_clip(flipped, y, x, h, w) for x, y in boxes)
        return crops


class RandomRotation:
    """Rotate the whole clip by one uniform angle (video_transforms.py:159-201).

    PIL ``rotate`` (expand=False), both input kinds — the released numpy
    branch called the removed ``scipy.misc.imrotate``.
    """

    def __init__(self, degrees, rng=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("If degrees is a single number,"
                                 "must be positive")
            degrees = (-degrees, degrees)
        elif len(degrees) != 2:
            raise ValueError("If degrees is a sequence,"
                             "it must be of len 2.")
        self.degrees = degrees
        self.rng = rng or _random_module

    def __call__(self, clip):
        angle = self.rng.uniform(self.degrees[0], self.degrees[1])
        if _is_numpy_clip(clip):
            return [np.asarray(Image.fromarray(
                np.ascontiguousarray(img)).rotate(angle)) for img in clip]
        if _is_pil_clip(clip):
            return [img.rotate(angle) for img in clip]
        raise TypeError("Expected numpy.ndarray or PIL.Image but got list "
                        f"of {type(clip[0])}")


def adjust_brightness(img: "Image.Image", factor: float) -> "Image.Image":
    return ImageEnhance.Brightness(img).enhance(factor)


def adjust_saturation(img: "Image.Image", factor: float) -> "Image.Image":
    return ImageEnhance.Color(img).enhance(factor)


def adjust_contrast(img: "Image.Image", factor: float) -> "Image.Image":
    return ImageEnhance.Contrast(img).enhance(factor)


def adjust_hue(img: "Image.Image", factor: float) -> "Image.Image":
    """Shift hue by ``factor`` of a full turn (torchvision's PIL recipe:
    HSV round-trip with uint8 wraparound on the H channel)."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue_factor ({factor}) is not in [-0.5, 0.5].")
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    # torchvision added np.uint8(factor*255) in place, relying on uint8
    # wraparound; modern numpy rejects negative scalars — wrap explicitly
    shift = np.uint8(int(factor * 255) % 256)
    np_h = (np_h + shift).astype(np.uint8)
    h = Image.fromarray(np_h, "L")
    return Image.merge("HSV", (h, s, v)).convert(img.mode)


class ColorJitter:
    """Random brightness/contrast/saturation/hue jitter
    (video_transforms.py:321-403).

    Faithful mode reproduces the released apply loop, which binds each op to
    the ORIGINAL frame and keeps only the last result — so exactly one
    (shuffle-chosen) jitter is ever applied (l.394-398). ``corrected=True``
    chains all enabled ops in the shuffled order (the evident intent, and
    torchvision's behavior). PIL clips only, as released.
    """

    def __init__(self, brightness: float = 0, contrast: float = 0,
                 saturation: float = 0, hue: float = 0, rng=None, *,
                 corrected: bool = False):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.corrected = corrected
        self.rng = rng or _random_module

    def get_params(self, brightness, contrast, saturation, hue):
        """Uniform factor draws, in the released order (l.341-364)."""
        b = self.rng.uniform(max(0, 1 - brightness), 1 + brightness) \
            if brightness > 0 else None
        c = self.rng.uniform(max(0, 1 - contrast), 1 + contrast) \
            if contrast > 0 else None
        s = self.rng.uniform(max(0, 1 - saturation), 1 + saturation) \
            if saturation > 0 else None
        hf = self.rng.uniform(-hue, hue) if hue > 0 else None
        return b, c, s, hf

    def __call__(self, clip):
        if _is_numpy_clip(clip):
            raise TypeError("Color jitter not yet implemented for numpy arrays")
        if not _is_pil_clip(clip):
            raise TypeError("Expected numpy.ndarray or PIL.Image but got "
                            f"list of {type(clip[0])}")
        b, c, s, hf = self.get_params(self.brightness, self.contrast,
                                      self.saturation, self.hue)
        ops = []  # built in the released order b, s, h, c (l.382-390)
        if b is not None:
            ops.append(lambda img: adjust_brightness(img, b))
        if s is not None:
            ops.append(lambda img: adjust_saturation(img, s))
        if hf is not None:
            ops.append(lambda img: adjust_hue(img, hf))
        if c is not None:
            ops.append(lambda img: adjust_contrast(img, c))
        self.rng.shuffle(ops)
        if not ops:
            return list(clip)
        out = []
        for img in clip:
            if self.corrected:
                for fn in ops:
                    img = fn(img)
                out.append(img)
            else:  # released: every fn sees the original, last one wins
                out.append(ops[-1](img))
        return out


def _clip_to_array(clip, channel_nb: int) -> np.ndarray:
    """(T, H, W, C) float64 array from a PIL/numpy clip, shape-checked the
    way the released converters are (volume_transforms.py:23-46)."""
    if _is_numpy_clip(clip):
        ch = clip[0].shape[2] if clip[0].ndim == 3 else 1
        assert ch == channel_nb, f"Got {ch} instead of {channel_nb} channels"
        frames = [np.asarray(img) for img in clip]
    elif _is_pil_clip(clip):
        frames = [np.array(img, copy=False) for img in clip]
    else:
        raise TypeError("Expected numpy.ndarray or PIL.Image but got list "
                        f"of {type(clip[0])}")
    frames = [f[..., None] if f.ndim == 2 else f for f in frames]
    return np.stack(frames, axis=0).astype(np.float64)


class ClipToTensor:
    """Clip → ``(C, T, H, W)`` in [0, 1] (volume_transforms.py:8-59).

    ``numpy=True`` returns a float numpy array (the host
    format); otherwise a torch FloatTensor like the reference. NOTE the hot
    path does NOT use this — clips ship uint8 NHWC and scale on device.
    """

    def __init__(self, channel_nb: int = 3, div_255: bool = True,
                 numpy: bool = False):
        self.channel_nb = channel_nb
        self.div_255 = div_255
        self.numpy = numpy

    def __call__(self, clip):
        arr = _clip_to_array(clip, self.channel_nb).transpose(3, 0, 1, 2)
        if self.div_255:
            arr = arr / 255.0
        if self.numpy:
            return arr
        import torch  # local: the data layer stays importable without torch
        return torch.from_numpy(arr).float()


class ToStackedTensor:
    """Clip → ``(T·C, H, W)`` in [0, 1] (stack_transforms.py:8-49)."""

    def __init__(self, channel_nb: int = 3):
        self.channel_nb = channel_nb

    def __call__(self, clip):
        arr = _clip_to_array(clip, self.channel_nb)  # (T, H, W, C)
        t, h, w, c = arr.shape
        arr = arr.transpose(0, 3, 1, 2).reshape(t * c, h, w) / 255.0
        import torch
        return torch.from_numpy(arr).float()


class ToTensor:
    """numpy → torch tensor, no scaling (volume_transforms.py:62-68)."""

    def __call__(self, array: np.ndarray):
        import torch
        return torch.from_numpy(array)


class Normalize:
    """Per-channel ``(x - mean) / std`` (tensor_transforms.py:6-30).

    In-place on torch tensors (the released ``sub_/div_``); numpy arrays are
    normalized in place when float, else returned as a new float array.
    """

    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, tensor):
        if isinstance(tensor, np.ndarray):
            if not np.issubdtype(tensor.dtype, np.floating):
                return (tensor - self.mean) / self.std
            tensor -= self.mean
            tensor /= self.std
            return tensor
        tensor.sub_(self.mean).div_(self.std)
        return tensor


class SpatialRandomCrop:
    """Random spatial crop of a ``(C, T, H, W)`` volume
    (tensor_transforms.py:33-59). The released width slice used the height
    extent (``x1:x1 + h``, l.58) — fixed here, documented divergence."""

    def __init__(self, size: Tuple[int, int], rng=None):
        self.size = size
        self.rng = rng or _random_module

    def __call__(self, tensor):
        h, w = self.size
        _, _, t_h, t_w = tensor.shape
        if w > t_w or h > t_h:
            raise ValueError(
                "Initial tensor spatial size should be larger then cropped "
                f"size but got cropped sizes : ({w}, {h}) while initial "
                f"tensor is ({t_w}, {t_h})")
        x1 = self.rng.randint(0, t_w - w)
        y1 = self.rng.randint(0, t_h - h)
        return tensor[:, :, y1:y1 + h, x1:x1 + w]

"""The host's C++ JPEG clip decoder (the port's copy of
``litemkd_tpu/native``): libjpeg decode, shorter-side bilinear resize, crop
and flip of a whole clip in one call, with no Python object touched, so
ctypes releases the GIL and a thread pool decodes clips in parallel.

``clipdec.cpp`` is built with g++ against the system libjpeg at first use,
into ``litemkd_torch/_build/`` under a name that carries a hash of the
source, and installed with an atomic ``os.replace``, so two processes that
build at once never load a half-written library. Where g++ or libjpeg is
missing, :func:`load` returns None and the callers (``data/video.py``)
decode with PIL: the JAX package's host-side decode rule, not a device
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "clipdec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Path:
    """Compile ``clipdec.cpp`` into ``_build/`` unless a library built from
    the same source is there; return its path. Raises when g++ or libjpeg
    is missing."""
    src = SOURCE.read_bytes()
    lib = BUILD_DIR / f"clipdec-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE),
           "-ljpeg"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{proc.stderr.strip()[-400:]}")
    os.replace(tmp, lib)   # atomic: a reader never sees a half-written library
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded decoder library, built first if needed; None (said once
    on stdout) where it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            print(f"[native] C++ clip decoder unavailable ({e}); clips "
                  "decode with PIL", flush=True)
            return None
        lib.clipdec_decode_clip.restype = ctypes.c_int
        lib.clipdec_decode_clip.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        lib.clipdec_decode_clip_mem.restype = ctypes.c_int
        lib.clipdec_decode_clip_mem.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def decode_clip(paths: List[str], resize_to: int, crop_y: int, crop_x: int,
                crop_size: int, flip: bool) -> Optional[np.ndarray]:
    """Decode, resize, crop (and flip) a clip natively → (T, S, S, 3) uint8.

    None if the library is unavailable or a frame fails to decode (the
    caller then decodes with PIL)."""
    lib = load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, crop_size, crop_size, 3), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.clipdec_decode_clip(
        arr, n, resize_to, crop_y, crop_x, crop_size, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out if rc == 0 else None


def decode_clip_mem(blobs: List[bytes], resize_to: int, crop_y: int,
                    crop_x: int, crop_size: int,
                    flip: bool) -> Optional[np.ndarray]:
    """:func:`decode_clip` over in-memory frames (zip-backed frame stores):
    each blob holds one frame's JPEG bytes."""
    lib = load()
    if lib is None:
        return None
    n = len(blobs)
    out = np.empty((n, crop_size, crop_size, 3), dtype=np.uint8)
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_ulong * n)(*[len(b) for b in blobs])
    rc = lib.clipdec_decode_clip_mem(
        bufs, lens, n, resize_to, crop_y, crop_x, crop_size, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    return out if rc == 0 else None

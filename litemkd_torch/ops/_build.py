"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is a self-contained source with a plain C interface. It
is compiled with nvcc for sm_90a into ``litemkd_torch/_build/`` (gitignored),
named by a hash of its source so a changed source builds anew, and loaded
with ctypes. Nothing is built when a module is imported: a kernel's wrapper
calls :func:`library` at its first launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def sources() -> Dict[str, Path]:
    """Kernel name (file stem) → source path, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a into ``_build/`` unless a
    library built from the same source is already there; return its path."""
    source = CSRC / f"{name}.cu"
    src = source.read_bytes()
    lib = BUILD_DIR / f"{name}-{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, lib)   # atomic: a reader never sees a half-written library
    return lib


def build_all() -> Dict[str, Path]:
    """Build every kernel library, one nvcc process per source, all at once."""
    names = list(sources())
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)))

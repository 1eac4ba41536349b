"""litemkd_torch — the PyTorch/CUDA port of litemkd_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module names and paths.
It imports torch and numpy only: nothing of JAX and nothing of litemkd_tpu.
Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA C++
kernels under ``csrc/`` (built with nvcc at first use, loaded with ctypes).

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` / ``device="cpu"``), where every kernel wrapper takes its
plain PyTorch version.
"""

__version__ = "0.1.0"

from .config import (Config, EpisodeConfig, ModelConfig, DistillConfig,
                     TrainConfig, DataConfig, MeshConfig, preset)

__all__ = ["Config", "EpisodeConfig", "ModelConfig", "DistillConfig",
           "TrainConfig", "DataConfig", "MeshConfig", "preset", "__version__"]

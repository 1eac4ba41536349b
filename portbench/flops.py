"""The frozen FLOP counts of the configuration files, worked out from the
plain reference through torch's ``FlopCounterMode`` (2 per multiply-add of
every convolution and matrix product, the TCT's two products among them),
under a ``FakeTensorMode``: shapes only, no memory. What each family
counts, and how its operations split by operand dtype as the
configuration states it, is its module's ``flop_counts``.

    python3 -m portbench.flops portbench/configs/<config>.json

prints the counts to put under the file's ``flops``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]


def count(fn) -> float:
    """Operations that ``fn()`` runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def shapes_only() -> FakeTensorMode:
    return FakeTensorMode(allow_non_fake_inputs=True)


def counts(cfg_file: Dict, root: Path = ROOT) -> Dict[str, Dict[str, float]]:
    from portbench import spec
    return spec.code(root, "families", cfg_file["family"]).flop_counts(cfg_file)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    for path in sys.argv[1:]:
        with open(path) as f:
            print(path, json.dumps(counts(json.load(f))))

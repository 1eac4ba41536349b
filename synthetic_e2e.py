#!/usr/bin/env python3
"""End-to-end rates of the port's synthetic eval and training on one GPU,
for the ``litemkd_torch`` package under ``--root`` (default: beside this
script), so that two checkouts can be compared on one card:

    python3 synthetic_e2e.py --root OTHER_CHECKOUT

Runs ``chip_smoke.py``'s phase 4 and phase 5 CLI calls: full-width
``student_fc2sup_dist`` eval of 16 synthetic episodes through
``litemkd_torch.cli.test.main``, then 2 training steps of 16 episodes with
the BN kernels and an 8-episode eval through ``litemkd_torch.cli.train.main``.
Prints the card's name and power limit, then one JSON line: wall seconds
and episodes/s of each, and the seconds spent in the host's synthetic draws
(``SyntheticEpisodeSource.sample_batch``) on whichever thread drew them.
"""
import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=str(Path(__file__).resolve().parent))
    root = Path(p.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("synthetic_e2e: CUDA is not available", file=sys.stderr)
        return 2
    import litemkd_torch
    from litemkd_torch.cli import test as cli_test
    from litemkd_torch.cli import train as cli_train
    from litemkd_torch.data import SyntheticEpisodeSource
    from litemkd_torch.ops import _build
    if Path(litemkd_torch.__file__).resolve().parent != root / "litemkd_torch":
        raise RuntimeError(f"imported {litemkd_torch.__file__}, not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(), flush=True)
    _build.build_all()

    draw = [0.0]
    sample_batch = SyntheticEpisodeSource.sample_batch

    def timed(self, *a, **k):
        t = time.perf_counter()
        out = sample_batch(self, *a, **k)
        draw[0] += time.perf_counter() - t
        return out

    def run(fn, argv):
        draw[0] = 0.0
        t0 = time.perf_counter()
        fn(argv)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, draw[0]

    common = ["--preset", "student_fc2sup_dist", "--dataset", "synthetic",
              "--device", "cuda"]
    run_dir = root / ".chip_smoke" / "e2e"
    shutil.rmtree(run_dir, ignore_errors=True)
    SyntheticEpisodeSource.sample_batch = timed
    try:
        eval_s, eval_draw = run(cli_test.main, common + [
            "--num_test_tasks", "16", "--synthetic_noise", "1.0"])
        train_s, train_draw = run(cli_train.main, common + [
            "--pallas_bn", "--training_iterations", "32", "--test_iters", "32",
            "--num_test_tasks", "8", "--print_freq", "1", "-c", str(run_dir)])
    finally:
        SyntheticEpisodeSource.sample_batch = sample_batch
        shutil.rmtree(run_dir, ignore_errors=True)
    print(json.dumps(dict(root=root.name, eval_s=eval_s, eval_eps_s=16 / eval_s,
                          eval_draw_s=eval_draw, train_s=train_s,
                          train_eps_s=32 / train_s, train_draw_s=train_draw)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

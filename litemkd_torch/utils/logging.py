"""Metrics logger (port of ``litemkd_tpu/utils/logging.py``): scalars go to
stdout every ``print_freq`` steps and, with a ``log_dir``, to a JSONL
stream and a text log; with ``use_wandb`` also to a wandb run, where the
package imports and initialises (otherwise a notice on stderr, and the run
goes on without it, as in the JAX package). A ``quiet`` logger (a
data-parallel rank other than 0) prints nothing."""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 print_freq: int = 10, use_wandb: bool = False,
                 quiet: bool = False):
        self.print_freq = 0 if quiet else print_freq
        self.quiet = quiet
        self.run_name = run_name
        self._t0 = time.time()
        self._jsonl = self._text = self._wandb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            base = os.path.join(log_dir, f"{stamp}_{run_name}")
            self._jsonl = open(f"{base}.jsonl", "a", buffering=1)
            self._text = open(f"{base}.log", "a", buffering=1)
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                if wandb.run is None:   # reference: wandb.init (trainwandb.py:41)
                    wandb.init(project="litemkd_torch", name=run_name)
            except ImportError:
                print("[metrics] wandb requested but not installed; skipping",
                      file=sys.stderr)
            except Exception as e:   # offline/no-credentials boxes
                self._wandb = None
                print(f"[metrics] wandb init failed ({e}); skipping",
                      file=sys.stderr)

    def log(self, step: int, scalars: Dict[str, float],
            force_print: bool = False) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._wandb and self._wandb.run:
            self._wandb.log(scalars, step=int(step))
        if force_print or (self.print_freq and step % self.print_freq == 0):
            body = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
            print(f"[{self.run_name} {step}] {body}", flush=True)

    def info(self, msg: str) -> None:
        if not self.quiet:
            print(msg, flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps({"info": msg}) + "\n")
        if self._text:
            self._text.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}\n")

    def close(self) -> None:
        for f in (self._jsonl, self._text):
            if f:
                f.close()
        self._jsonl = self._text = None

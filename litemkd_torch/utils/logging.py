"""Metrics logger (port of ``litemkd_tpu/utils/logging.py`` without the
wandb sink): scalars go to stdout every ``print_freq`` steps and, with a
``log_dir``, to a JSONL stream and a text log."""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run",
                 print_freq: int = 10):
        self.print_freq = print_freq
        self.run_name = run_name
        self._t0 = time.time()
        self._jsonl = self._text = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S")
            base = os.path.join(log_dir, f"{stamp}_{run_name}")
            self._jsonl = open(f"{base}.jsonl", "a", buffering=1)
            self._text = open(f"{base}.log", "a", buffering=1)

    def log(self, step: int, scalars: Dict[str, float],
            force_print: bool = False) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in scalars.items()})
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
        if force_print or (self.print_freq and step % self.print_freq == 0):
            body = " ".join(f"{k}={v:.5g}" for k, v in scalars.items())
            print(f"[{self.run_name} {step}] {body}", flush=True)

    def info(self, msg: str) -> None:
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

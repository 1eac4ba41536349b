"""Interactive episode demo (port of ``litemkd_tpu/cli/demo.py``; the
reference's pywebio demo, ``multi_fusion.py:655-756``, without the external
dependency): serves a small HTML page that samples an episode, runs the
model, and shows per-query predictions against the truth. Works with the
synthetic dataset out of the box, and on the frames of a JPEG-tree
checkpoint's dataset.

    python -m litemkd_torch.cli.demo --preset tiny --dataset synthetic --port 8089
    # then open http://localhost:8089
    python -m litemkd_torch.cli.demo -m RUN/checkpoint_N.pt --once
    python -m litemkd_torch.cli.demo -m RUN/model.litemkd --port 0

``-m`` takes a student checkpoint ``.pt`` of the port (or any
reference-layout student ``.pt``) or a ``.litemkd`` artifact of ``cli.export
--aot`` (served with no model code); without it the student has random
weights. ``--once`` prints one episode's rows as JSON on stdout (status
goes to stderr); ``--port 0`` binds a free port and prints it. Runs on cuda
unless ``--device`` says otherwise, with TF32 off.
"""
from __future__ import annotations

import argparse
import contextlib
import html
import json
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.dtypes import set_fp32_math
from .common import (add_common_args, add_device_arg, build_config,
                     build_sampler, load_saved_config, resolve_device)


def _on_device(batch, device, label_dtype=torch.int64):
    """The episode's support clips, labels and query clips as tensors on
    ``device``."""
    return (torch.from_numpy(np.ascontiguousarray(batch.support_clips)).to(device),
            torch.from_numpy(np.asarray(batch.support_labels)).to(device, label_dtype),
            torch.from_numpy(np.ascontiguousarray(batch.query_clips)).to(device))


def build_runner(cfg, checkpoint: Optional[str] = None,
                 device=None) -> Callable[[int], list]:
    """``run_episode(seed)`` → one row a query (``query``, ``predicted``,
    ``true``, ``correct``, ``logits``) of an episode that the configured
    sampler draws from ``seed``, scored by the student of ``checkpoint``
    (a ``.pt``, or a ``.litemkd`` scorer artifact whose geometry must be
    the config's) or by a random-weight student."""
    device = resolve_device(device)
    sampler = build_sampler(cfg, need_teacher=False)

    if checkpoint and checkpoint.endswith(".litemkd"):
        # serve an AOT artifact (cli.export --aot): the exported program with
        # its weights, the production serving path, no model build at all
        from ..tools.aot import load_serving_artifact
        scorer, m = load_serving_artifact(checkpoint, device)
        if m.get("kind", "scorer") != "scorer":
            raise ValueError(f"{checkpoint} is a {m['kind']!r} artifact — "
                             "the demo serves episodic scorers")
        for key, want in (("way", cfg.episode.way), ("shot", cfg.episode.shot),
                          ("queries", cfg.episode.n_queries(False)),
                          ("img_size", cfg.episode.img_size),
                          ("seq_len", cfg.episode.seq_len), ("episodes", 1)):
            if m.get(key) != want:
                raise ValueError(
                    f"artifact geometry mismatch: {key}={m.get(key)} but the "
                    f"demo config needs {want} (re-export with matching "
                    "--preset/--aot_episodes 1)")
        print(f"serving AOT artifact {checkpoint} "
              f"(platforms={m['platforms']})", file=sys.stderr)
        label_dtype = getattr(torch, m["input_dtypes"]["support_labels"])
        exported_on = m["device"]

        def score(batch):
            return scorer(*_on_device(batch, exported_on, label_dtype))[0]
    else:
        from ..distill import merge_logits
        from .test import load_student
        set_fp32_math()
        if checkpoint:
            # the reference demo serves a trained model
            # (multi_fusion.py:676-680); status goes to stderr — `--once`
            # stdout must stay pure JSON
            print(f"loaded checkpoint {checkpoint}", file=sys.stderr)
        else:
            print("WARNING: no --test_model_path given — serving RANDOM "
                  "weights", file=sys.stderr)
        model = load_student(cfg, checkpoint, device)

        def score(batch):
            with torch.inference_mode():
                out = model(*_on_device(batch, device))
                return merge_logits(cfg.distill.name, out["logits"])[0]

    def run_episode(seed: int):
        r = np.random.default_rng(seed)
        batch = sampler.sample_batch(r, 1, train=False)
        logits = score(batch).float().cpu().numpy()
        preds = logits.argmax(-1)
        truth = np.asarray(batch.query_labels)[0]
        return [{"query": int(i), "predicted": int(p), "true": int(t),
                 "correct": bool(p == t),
                 "logits": [round(float(x), 4) for x in logits[i]]}
                for i, (p, t) in enumerate(zip(preds, truth))]

    return run_episode


def page(cfg, seed: int, rows: list) -> bytes:
    """The HTML page of one episode's rows."""
    acc = sum(r["correct"] for r in rows) / len(rows)
    body = ["<html><head><title>litemkd_torch demo</title></head><body>",
            f"<h2>{cfg.episode.way}-way {cfg.episode.shot}-shot episode "
            f"(seed {seed}) — accuracy {acc:.2f}</h2>",
            f'<p><a href="/?seed={seed + 1}">next episode</a></p>',
            "<table border=1 cellpadding=4><tr><th>query</th>"
            "<th>predicted</th><th>true</th><th>ok</th><th>logits</th></tr>"]
    for r in rows:
        body.append(
            f"<tr><td>{r['query']}</td><td>{r['predicted']}</td>"
            f"<td>{r['true']}</td><td>{'✓' if r['correct'] else '✗'}</td>"
            f"<td>{html.escape(str(r['logits']))}</td></tr>")
    body.append("</table></body></html>")
    return "\n".join(body).encode()


def make_server(cfg, run_episode: Callable[[int], list], port: int = 8089,
                host: str = "127.0.0.1") -> HTTPServer:
    """An HTTP server whose ``GET /?seed=N`` answers episode N's page
    (seed 0 without one); ``port`` 0 binds a free port
    (``server.server_address[1]``)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            seed = 0
            if "seed=" in self.path:
                try:
                    seed = int(self.path.split("seed=")[1].split("&")[0])
                except ValueError:
                    pass
            data = page(cfg, seed, run_episode(seed))
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    return HTTPServer((host, port), Handler)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    add_device_arg(p)
    p.add_argument("--port", type=int, default=8089)
    p.add_argument("--test_model_path", "-m", default=None,
                   help="student .pt or .litemkd AOT artifact to serve "
                        "(random weights otherwise)")
    p.add_argument("--once", action="store_true",
                   help="print one episode's results as JSON and exit (no server)")
    args = p.parse_args(argv)
    cfg = build_config(args, base=load_saved_config(args.test_model_path))
    if args.once:
        # stdout carries the JSON alone: notes of the data path go to stderr
        with contextlib.redirect_stdout(sys.stderr):
            rows = build_runner(cfg, args.test_model_path, args.device)(0)
        print(json.dumps(rows, indent=2))
        return rows

    run_episode = build_runner(cfg, args.test_model_path, args.device)

    server = make_server(cfg, run_episode, args.port)
    print(f"demo serving on http://127.0.0.1:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

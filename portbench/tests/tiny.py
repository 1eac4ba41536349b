"""A benchmark root of tiny cells, written into a folder of the caller's, for
the CPU tests: the same files a real cell has (BENCHMARK.json, a
configuration, a traffic mix, a cell file), at the ``tiny`` preset's
sizes."""
from __future__ import annotations

import json
from pathlib import Path

STUDENT = {
    "name": "tiny_student", "family": "student", "preset": "tiny",
    "source": "https://github.com/HuiGuanLab/Lite-MKD", "reduced": [],
    "overrides": {"train": {"micro_batch": 1, "sch": [1000000]}},
    "sizes": {
        "episode": {"way": 3, "shot": 2, "query_per_class": 2, "query_per_class_test": 1,
                    "seq_len": 4, "img_size": 32},
        "model": {"backbone": "resnet18_2fc", "classifier": "TRX_2fcsup",
                  "teacher": "TRX_2fcsup_fixed", "trans_linear_in_dim": 64,
                  "trans_linear_out_dim": 32, "temp_set": [2], "trans_dropout": 0.1,
                  "compute_dtype": "bfloat16"},
        "train": {"tasks_per_batch": 2, "micro_batch": 1, "learning_rate": 1e-4,
                  "optimizer": "sgd"},
        "distill": {"name": "fc_2_sup_dist", "temperature": 4.0, "sup_weight": 0.5}},
    "flops": {"train_step": {"bf16": 1.0e9, "fp32": 1.0e8},
              "serve_request": {"bf16": 1.0e8, "fp32": 1.0e7}},
}

MFM = {
    "name": "tiny_mfm", "family": "mfm", "preset": "tiny",
    "source": "https://github.com/HuiGuanLab/Lite-MKD", "reduced": [],
    "overrides": {"model": {"backbone": "feature", "classifier": "MFM"},
                  "distill": {"name": "ce"}, "train": {"sch": [1000000]}},
    "sizes": {
        "episode": {"way": 3, "shot": 2, "query_per_class": 2, "query_per_class_test": 1,
                    "seq_len": 4},
        "model": {"trans_linear_in_dim": 64, "trans_linear_out_dim": 32, "temp_set": [2],
                  "trans_dropout": 0.1, "trans_num": 1, "shirt_num": 1,
                  "modalities": ["rgb", "depth", "flow"]},
        "train": {"tasks_per_batch": 2, "micro_batch": 0, "learning_rate": 1e-4,
                  "optimizer": "sgd"},
        "distill": {"name": "ce"}},
    "flops": {"train_step": {"fp32": 1.0e9}},
}

TRAIN_MIX = {"driver": "train_step", "pool": 3, "check_steps": 3, "trace_steps": 2}
SERVE_MIX = {"driver": "serve_open_loop", "rate_per_s": 20.0, "pool": 4,
             "gaps_seed": 1234, "check_requests": 4, "trace_requests": 4}
DP_MIX = {"driver": "train_step_dp", "ranks": 2, "pool": 3, "check_steps": 3,
          "trace_steps": 2}

# limits read off tiny runs on the CPU (bf16 trunk: program body 0.067-0.074,
# head 0.0045-0.0071, median change 0.008-0.011 over four seeds; the control
# 0.64-0.68 and 0.35-0.39; half the batch on the head 0.20-0.52; the update
# rule 0 on every seed, an update at 1.5 times its scale 0.5)
TRAIN_LIMITS = {"grad_cos_body": 0.3, "grad_cos_head": 0.05, "change_gap_median": 0.1,
                "update_gap": 0.1}
# the fp32 MFM against the fp32 reference: 2e-7, 1.6e-5, 4.3e-5; the rule 0
MFM_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-2, "update_gap": 0.1}
# program 0.19-0.31, control 1.1-2.8, an answer altered 1.9-2.8
SERVE_LIMITS = {"logit_gap": 0.6}


def write(root: Path, cells=("tiny.train",), extra_metrics=()) -> Path:
    """BENCHMARK.json and the data files of the tiny cells under ``root``."""
    root = Path(root)
    pb = root / "portbench"
    for d in ("configs", "traffic", "workloads"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    all_cells = {
        "tiny.train": ("tiny_student", "train_tiny", TRAIN_MIX, TRAIN_LIMITS),
        "tiny_mfm.train": ("tiny_mfm", "train_tiny", TRAIN_MIX, MFM_LIMITS),
        "tiny.serve": ("tiny_student", "serve_tiny", SERVE_MIX, SERVE_LIMITS),
        "tiny.train.dp2": ("tiny_student", "train_tiny_dp2", DP_MIX, TRAIN_LIMITS),
    }
    configs = {"tiny_student": STUDENT, "tiny_mfm": MFM}
    used = sorted({all_cells[c][0] for c in cells})
    for name in used:
        (pb / "configs" / f"{name}.json").write_text(json.dumps(configs[name]))
    workloads = []
    for c in cells:
        conf, traffic, mix, limits = all_cells[c]
        (pb / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        (pb / "workloads" / f"{c}.json").write_text(json.dumps({"limits": limits}))
        workloads.append({"name": c, "config": conf, "traffic": traffic,
                          "chips": 2 if c.endswith("dp2") else 1, "why": "test"})
    train = [c for c in cells if ".train" in c]
    serve = [c for c in cells if ".serve" in c]
    bench = {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"],
        "run_seconds": 1,
        "configs": [{"name": n, "source": configs[n]["source"],
                     "file": f"portbench/configs/{n}.json", "reduced": [], "why": "test"}
                    for n in used],
        "workloads": workloads,
        "end_to_end": [
            {"name": "train_eps_per_s", "unit": "episodes/s", "better": "higher",
             "bound": 0.05, "source": "host_clock", "workloads": train},
            {"name": "request_ms_p95", "unit": "ms", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": serve},
            {"name": "peak_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01,
             "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "mfu.train", "unit": "%", "better": "higher", "source": "device_trace",
             "layer": "train steps", "moves": "train_eps_per_s", "workloads": train},
            *extra_metrics],
    }
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m.get("workloads", [1]) != []]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root

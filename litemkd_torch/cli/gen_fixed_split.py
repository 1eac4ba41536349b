"""Fixed-episode generator (port of ``litemkd_tpu/cli/gen_fixed_split.py``;
the reference's ``splits/gen_fixed_split.py``): draws N test episodes and
writes them for exact replay through ``--fixed_episode_file``.

    python -m litemkd_torch.cli.gen_fixed_split --dataset hmdb \\
        --rgb_path FRAMES --traintestlist SPLITS --n_episodes 10000 \\
        --out fixed_test.json [--seed 3483] [--format reference]

Reads only the split index of the frame tree (or of the synthetic source);
nothing is decoded and no device is used.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..data import (draw_episode_spec, save_fixed_episodes,
                    save_reference_fixed_episodes)
from .common import add_common_args, build_config, build_sampler, episode_index


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_args(p)
    p.add_argument("--n_episodes", type=int, default=10000)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=3483)
    p.add_argument("--format", choices=["native", "reference"],
                   default="native",
                   help="'reference' writes the reference's fixed_test schema "
                        "(class_bc + global video_idx); give --out a .yaml "
                        "name to replay it in the reference codebase, whose "
                        "JSON reader cannot read its own schema")
    args = p.parse_args(argv)
    cfg = build_config(args)

    sampler = build_sampler(cfg, need_teacher=False)
    index = episode_index(sampler, train=False)
    rng = np.random.default_rng(args.seed)
    ep = cfg.episode
    specs = [draw_episode_spec(index, ep.way, ep.shot, ep.query_per_class_test,
                               rng) for _ in range(args.n_episodes)]
    if args.format == "reference":
        save_reference_fixed_episodes(specs, index, args.out)
    else:
        save_fixed_episodes(specs, args.out)
    print(f"wrote {len(specs)} fixed episodes → {args.out}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The defaults grid of the PyTorch port on one NVIDIA GPU.

The counterpart of tools/ab_defaults.py, with its flags, variants and sim:

    python tools/torch_ab_defaults.py [--scans 200] [--cols 1024] [--seed 0]

The knobs where the system deviates from the reference's semantics for
speed: approx_knn (exact in the reference), scan2map_rebind_every (the
reference rebinds every iteration), scan2map_candidates and
scan2map_max_iterations (the reference runs 30). Each variant changes one
knob of `RoloConfig()` and runs the full SlamSystem over the same sim
sequence (`runtime.dataset.run_simulated`, priors on) on the card, one
system at a time. The default row's label is built from the shipped
config's values. Prints one JSON line per variant and one summary line on
stdout (the last, beside the card's nvidia-smi name and power limit).
Needs a CUDA device; writes no file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.append(os.path.dirname(os.path.abspath(__file__)))  # torch_ab_study, when loaded by file

import torch  # noqa: E402

from torch_ab_study import run_variant  # noqa: E402

SUMMARY_KEYS = ("ate_keyframes_rmse_m", "ate_frontend_rmse_m", "scans_per_s", "n_keyframes",
                "variant_wall_s")


def variants(base) -> dict:
    """ab_defaults.py:51-62, one knob of `base.mapping` changed per row."""
    m = base.mapping

    def with_mapping(**kw):
        return base.replace(mapping=dataclasses.replace(m, **kw))

    default = (f"default (approx={'T' if m.approx_knn else 'F'} "
               f"rebind={m.scan2map_rebind_every} cand={m.scan2map_candidates} "
               f"iters={m.scan2map_max_iterations})")
    return {
        default: base,
        "exact_knn": with_mapping(approx_knn=False),
        "rebind_every_1 (reference semantics)": with_mapping(scan2map_rebind_every=1),
        "rebind_every_10": with_mapping(scan2map_rebind_every=10),
        "candidates_64": with_mapping(scan2map_candidates=64),
        "iters_30 (reference count)": with_mapping(scan2map_max_iterations=30),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_defaults.py needs a CUDA device")
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.sim import SimConfig

    sim = SimConfig(n_scans=args.scans, n_cols=args.cols, sensor="velodyne32", period=24.0,
                    seed=args.seed)
    results = {}
    for name, cfg in variants(RoloConfig()).items():
        results[name] = run_variant(cfg, True, sim, torch.device("cuda"))
        print(json.dumps({"variant": name, **{k: results[name].get(k) for k in SUMMARY_KEYS}}),
              flush=True)
    print(json.dumps({"sim": dataclasses.asdict(sim), "machine": bench_metadata(),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

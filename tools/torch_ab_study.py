#!/usr/bin/env python3
"""A/B accuracy study of the PyTorch port on one NVIDIA GPU.

The counterpart of tools/ab_study.py, with its flags, variants and sim:

    python tools/torch_ab_study.py [--scans 300] [--cols 1024]
        [--variants baseline,no_deskew,no_loops,no_priors]

Each variant (deskew, loop closure or the ground priors on or off against
`RoloConfig()`) runs the full SlamSystem over the same raycast sequence
(motion distortion, uneven terrain, one loop revisit) through
`runtime.dataset.run_simulated` on the card, one system at a time, and
reports the front-end and keyframe ATE with the run's counts and rates.
Prints one JSON line per variant and one summary line on stdout (the last,
beside the card's nvidia-smi name and power limit). Needs a CUDA device;
writes no file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

VARIANTS = ("baseline", "deskew", "no_deskew", "no_loops", "no_priors", "no_loops_no_priors")


def variant_config(base, name: str):
    """(config, with_priors) of a variant (ab_study.py:65-86)."""
    if name == "baseline":
        return base, True
    if name in ("deskew", "no_deskew"):
        return base.replace(sensor=dataclasses.replace(
            base.sensor, deskew_enabled=name == "deskew")), True
    no_loops = base.replace(loop=dataclasses.replace(base.loop, enable=False))
    if name == "no_loops":
        return no_loops, True
    if name == "no_priors":
        return base, False
    if name == "no_loops_no_priors":
        # z / roll / pitch drift is correctable by the priors only where the
        # loops do not already pin it
        return no_loops, False
    raise ValueError(f"unknown variant {name!r}; one of {', '.join(VARIANTS)}")


def run_variant(cfg, with_priors: bool, sim, device) -> dict:
    """One full run_simulated: the result's JSON row with its wall seconds.
    Progress lines go to stderr; the system is dropped before returning."""
    from rolo_tpu_torch.runtime.dataset import run_simulated

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = run_simulated(cfg, sim, with_priors=with_priors, progress_every=50, device=device)
    row = res.to_json()
    row["variant_wall_s"] = round(time.perf_counter() - t0, 1)
    gc.collect()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=300)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--period", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--roughness", type=float, default=1.0)
    ap.add_argument("--noise-std", type=float, default=0.02)
    ap.add_argument("--dropout", type=float, default=0.05)
    ap.add_argument("--boxes", type=int, default=14)
    ap.add_argument("--cyls", type=int, default=24)
    ap.add_argument("--variants", default="baseline,no_deskew,no_loops,no_priors")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_study.py needs a CUDA device")
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.sim import SimConfig

    sim = SimConfig(n_scans=args.scans, n_cols=args.cols, sensor="velodyne32",
                    period=args.period, seed=args.seed, roughness=args.roughness,
                    noise_std=args.noise_std, dropout=args.dropout, n_boxes=args.boxes,
                    n_cyls=args.cyls)
    results = {}
    for name in args.variants.split(","):
        cfg, with_priors = variant_config(RoloConfig(), name)
        results[name] = run_variant(cfg, with_priors, sim, torch.device("cuda"))
        print(json.dumps({"variant": name, **results[name]}), flush=True)
    print(json.dumps({"sim": dataclasses.asdict(sim), "machine": bench_metadata(),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

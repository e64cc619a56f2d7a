#!/usr/bin/env python3
"""Per-stage cost of the port's SLAM loop on the card, for comparing two
checkouts of `rolo_tpu_torch` inside one call.

    python tools/torch_step_costs.py [--root DIR] [--scans N]

Imports the package from DIR (default: this checkout), runs the first N
frames of the bench simulation (chip_smoke.py's lap, `RoloConfig()`
capacities) through `run_frames(SlamSystem(RoloConfig()), ...)` after ten
warm-up frames on a throwaway system, and prints one JSON line: the card's
nvidia-smi name and power limit, scans/s, and each StageTimers stage's count
and p50 ms (`backend` is `backend_step`, `graph_solve` `solve_graph_host`).
Needs a CUDA device. Compare checkouts in one call, alternated (A B B A):
the host's speed moves every number between calls.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--scans", type=int, default=80)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    import rolo_tpu_torch
    from rolo_tpu_torch import bench
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.dataset import run_frames
    from rolo_tpu_torch.runtime.platform import configure_precision, nvidia_smi_name_power
    from rolo_tpu_torch.runtime.slam import SlamSystem
    from rolo_tpu_torch.sim.dataset import generate_sequence

    if not os.path.abspath(rolo_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"rolo_tpu_torch came from {rolo_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_step_costs.py needs a CUDA device")
    configure_precision()
    cfg = RoloConfig()
    frames = list(generate_sequence(bench.bench_sim_config(args.scans), torch.device("cuda")))
    run_frames(SlamSystem(cfg), frames[:10])  # kernel builds, allocator and cuBLAS warm-up
    slam = SlamSystem(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_frames(slam, frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stages = slam.timers.summary()
    print(json.dumps({
        "root": root, "card": nvidia_smi_name_power(), "scans": len(frames),
        "seconds": seconds, "scans_per_s": len(frames) / seconds,
        "stages": {k: {"count": v["count"], "p50_ms": v["p50_ms"]} for k, v in stages.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

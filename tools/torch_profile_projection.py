#!/usr/bin/env python3
"""Per-op timing of the PyTorch port's ingest path on one NVIDIA GPU.

The counterpart of tools/profile_projection.py, with its scan and rows:

    python tools/torch_profile_projection.py [--iters 20] [--out FILE]

One simulated 32-beam x 1024-column scan padded to `RoloConfig()`'s raw
capacity: `project_scan` (range image), `extract_features` (LOAM corners and
surfaces), `concat_clouds` (the front-end's input), and projection and
extraction together. Each row holds the mean wall ms per call over
`--iters` calls ending in one synchronize, and one synchronized call under
torch.profiler: kernel ms, launches, the host's waits and the top kernels
(`rolo_tpu_torch.bench.stage_row`).

Prints one JSON line per row, then the report, beside the card's nvidia-smi
name and power limit. Writes the report to `--out` only when given. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

STAGES = ("project_scan", "extract_features", "concat_clouds", "project+extract fused")


def sim_config(n_cols: int = 1024, sensor: str = "velodyne32"):
    """profile_projection.py:53."""
    from rolo_tpu_torch.sim import SimConfig

    return SimConfig(n_scans=1, n_cols=n_cols, sensor=sensor, seed=0)


def profile(device, cfg=None, sim=None, iters: int = 20) -> dict:
    """Every row of profile_projection.py:45-77 on `device`, as a report."""
    from rolo_tpu_torch.bench import stage_row
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.pointcloud import features as feats
    from rolo_tpu_torch.pointcloud.cloud import concat_clouds
    from rolo_tpu_torch.pointcloud.projection import RawScan, project_scan
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.sim.dataset import generate_sequence

    device = torch.device(device)
    cfg = RoloConfig() if cfg is None else cfg
    sim = sim_config() if sim is None else sim
    st, sc = cfg.static, cfg.sensor
    frame = next(iter(generate_sequence(sim, device)))
    cap = st.max_raw_points
    n = min(frame.points.shape[0], cap)
    xyz = torch.zeros(cap, 3, device=device)
    ring = torch.zeros(cap, dtype=torch.int32, device=device)
    rel = torch.zeros(cap, device=device)
    xyz[:n], ring[:n], rel[:n] = frame.points[:n, :3], frame.ring[:n], frame.rel_time[:n]
    scan = RawScan(xyz, ring, rel, torch.arange(cap, device=device) < n)
    rows = {}

    def timeit(name, fn):
        rows[name], out = stage_row(fn, device, iters)
        return out

    def proj(s):
        return project_scan(s, sc.n_scan, sc.horizon_scan, sc.lidar_min_range,
                            sc.lidar_max_range, sc.downsample_rate)

    def ext(r):
        return feats.extract_features(r, cfg.features.edge_threshold,
                                      cfg.features.surf_threshold,
                                      cfg.features.odometry_surf_leaf_size,
                                      st.max_corner_points, st.max_surf_points)

    ring_img = timeit("project_scan", lambda: proj(scan))
    fc = timeit("extract_features", lambda: ext(ring_img))
    feat = timeit("concat_clouds",
                  lambda: concat_clouds(fc.corners, fc.surfaces, st.max_feature_points))
    timeit("project+extract fused", lambda: ext(proj(scan)))
    return {"shapes": {"raw_points": n, "raw_capacity": cap, "n_scan": sc.n_scan,
                       "horizon_scan": sc.horizon_scan},
            "counts": {"corners": int(fc.corners.mask.sum()),
                       "surfaces": int(fc.surfaces.mask.sum()), "features": int(feat.mask.sum())},
            "stage_ms": {name: r["wall_ms"] for name, r in rows.items()},
            "stages": rows, "machine": bench_metadata()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_projection.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import configure_precision

    configure_precision()
    report = profile(torch.device("cuda"), iters=args.iters)
    for stage, row in report["stages"].items():
        print(json.dumps({"stage": stage, **row}))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

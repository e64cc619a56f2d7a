"""Command-line entry point of the port, `python -m rolo_tpu_torch ...`, the
counterpart of `python -m rolo_tpu` (the reference's
`roslaunch rolo rolo_run.launch`).

Subcommands:
  run   - SLAM over a scan source (simulated / directory / rosbag); exports
          TUM / g2o / PCD and scores ATE when ground truth is available
  sim   - write a simulated sequence to disk (PCD scans + TUM ground truth)
  bench - the registration benchmark on one GPU (one JSON line)

`run` and `sim` work on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json


def _add_run(sub):
    p = sub.add_parser("run", help="run SLAM over a scan source")
    p.add_argument("--input", required=True,
                   help="'sim' | directory of .bin/.pcd scans | .bag file")
    p.add_argument("--config", action="append", default=None,
                   help="reference-format yaml; repeatable (e.g. params.yaml "
                        "+ prior_pose_params.yaml), applied in order")
    p.add_argument("--output", default="./rolo_out", help="export directory")
    p.add_argument("--gt", default=None, help="TUM ground-truth file (dir/bag inputs)")
    p.add_argument("--topic", default=None, help="PointCloud2 topic (bag input)")
    p.add_argument("--rate", type=float, default=10.0, help="synthesized stamp rate for dirs")
    p.add_argument("--sim-scans", type=int, default=260)
    p.add_argument("--sim-cols", type=int, default=1024)
    p.add_argument("--sim-period", type=float, default=24.0)
    p.add_argument("--sim-seed", type=int, default=0)
    p.add_argument("--sim-sensor", default="velodyne32", choices=["velodyne32", "velodyne16"])
    p.add_argument("--no-priors", action="store_true")
    p.add_argument("--progress", type=int, default=20)
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def _add_sim(sub):
    p = sub.add_parser("sim", help="write a simulated sequence to disk")
    p.add_argument("--output", required=True)
    p.add_argument("--scans", type=int, default=120)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--period", type=float, default=24.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sensor", default="velodyne32", choices=["velodyne32", "velodyne16"])
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p


def main(argv=None) -> int:
    from .runtime.platform import configure_precision

    configure_precision()
    ap = argparse.ArgumentParser(prog="rolo_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run(sub)
    _add_sim(sub)
    sub.add_parser("bench", help="registration benchmark on one GPU (one JSON line)")
    args = ap.parse_args(argv)

    if args.cmd == "bench":
        from . import bench

        return bench.main()

    if args.cmd == "sim":
        import os

        import numpy as np

        from .runtime import io as rio
        from .sim.dataset import SimConfig, generate_sequence

        os.makedirs(args.output, exist_ok=True)
        cfg = SimConfig(n_scans=args.scans, n_cols=args.cols, period=args.period,
                        seed=args.seed, sensor=args.sensor)
        gt_rows = []
        for frame in generate_sequence(cfg, args.device):
            rio.write_pcd(os.path.join(args.output, f"{frame.stamp:010.4f}.pcd"),
                          frame.points.cpu().numpy())
            gt_rows.append((frame.stamp, frame.gt_trans.cpu().numpy()))
        quats = np.tile(np.array([1.0, 0, 0, 0]), (len(gt_rows), 1))
        rio.write_tum(os.path.join(args.output, "gt_tum.txt"), [t for t, _ in gt_rows],
                      np.stack([p for _, p in gt_rows]), quats)
        print(f"wrote {len(gt_rows)} scans + gt_tum.txt to {args.output}")
        return 0

    from .config import load_config
    from .runtime import dataset as ds
    from .runtime.slam import SlamSystem

    cfg = load_config(args.config)
    if args.input == "sim":
        from .sim.dataset import SimConfig

        sim_cfg = SimConfig(n_scans=args.sim_scans, n_cols=args.sim_cols,
                            period=args.sim_period, seed=args.sim_seed, sensor=args.sim_sensor)
        res = ds.run_simulated(cfg, sim_cfg, out_dir=args.output,
                               with_priors=not args.no_priors, progress_every=args.progress,
                               device=args.device)
    else:
        if args.input.endswith(".bag"):
            frames = ds.frames_from_bag(args.input, topic=args.topic)
        else:
            frames = ds.frames_from_dir(args.input, rate_hz=args.rate)
        gt = ds.gt_from_tum(args.gt) if args.gt else None
        res = ds.run_frames(SlamSystem(cfg, args.device), frames, gt=gt, out_dir=args.output,
                            progress_every=args.progress)
    print(json.dumps(res.to_json(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

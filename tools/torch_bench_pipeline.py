#!/usr/bin/env python3
"""End-to-end pipeline throughput of the PyTorch port on one NVIDIA GPU.

The counterpart of tools/bench_pipeline.py, with its flags, sim and report:

    python tools/torch_bench_pipeline.py [--scans 80] [--warmup 20] [--cols 1024]
        [--no-loops] [--no-priors] [--synced] [--peak-tflops 67]

`SlamSystem(RoloConfig())` scans/s over the measured window after a
warm-up (which ends with one graph solve and a reset of the stage timers),
on raycast scans of the simulator: projection, LOAM features, the
front-end, scan-to-submap mapping, the loop and prior cadences. With
--synced each stage waits for its own device work, so the stage times hold
device time. Also the stage times (mean, p50, count), the front-end's and
the keyframes' ATE, the drop and factor counts, and one front-end
`scan_step` at the run's real shapes: its device time (CUDA events over 10
calls after a warm one) and its aten matmul FLOPs (`FlopCounterMode`; a
lower bound, like the reference's XLA count, and 0 on the card, where the
step's k-NN runs in the K2 kernel) against the card's f32 peak.
Prints one JSON line on stdout, beside the card's nvidia-smi name and power
limit. Needs a CUDA device; writes no file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

# NVIDIA's H100 SXM f32 peak outside the tensor cores (chip_smoke.py's
# H100_F32_FLOPS): the port turns TF32 off
PEAK_TFLOPS = 67.0
FLOPS_SCOPE = ("aten matmuls only (FlopCounterMode), a lower bound: elementwise work and "
               "the two ctypes kernels are not counted, and on the card a scan_step reaches "
               "no aten matmul (its k-NN runs in the K2 kernel, its small products as "
               "addcmul), so the count is 0 there")


def sim_config(n_scans: int, cols: int = 1024):
    """bench_pipeline.py:84-85."""
    from rolo_tpu_torch.sim import SimConfig

    return SimConfig(n_scans=n_scans, n_cols=cols, sensor="velodyne32", period=24.0,
                     roughness=1.0, seed=0)


def config(loops: bool = True, priors: bool = True):
    """RoloConfig() with loops and priors as bench_pipeline.py:78-95 sets them."""
    from rolo_tpu_torch.config import RoloConfig

    cfg = RoloConfig()
    if not loops:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enable=False))
    if not priors:
        cfg = cfg.replace(prior=dataclasses.replace(cfg.prior, enable=False))
    return cfg


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frontend_step(slam, frame):
    """One front-end scan_step on `frame` at the run's shapes, from the
    system's odometry state (bench_pipeline.py:149-172): the scan projected
    with a zero deskew increment when deskew is on, LOAM features, then the
    step. Returns a callable."""
    from rolo_tpu_torch.frontend import odometry
    from rolo_tpu_torch.pointcloud.cloud import concat_clouds
    from rolo_tpu_torch.pointcloud.features import extract_features
    from rolo_tpu_torch.pointcloud.projection import project_scan

    cfg, st, s, dev = slam.cfg, slam.cfg.static, slam.cfg.sensor, slam.device
    scan = slam._make_raw_scan(frame.points, frame.ring, frame.rel_time)
    deskew = {}
    if s.deskew_enabled:
        zero = torch.zeros(3, device=dev)
        deskew = dict(deskew_rpy=zero, deskew_vel=zero,
                      odom_time_diff=torch.tensor(s.scan_period, device=dev))
    img = project_scan(scan, s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range,
                       s.downsample_rate, **deskew)
    fc = extract_features(img, cfg.features.edge_threshold, cfg.features.surf_threshold,
                          cfg.features.odometry_surf_leaf_size, st.max_corner_points,
                          st.max_surf_points)
    feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)
    dt = torch.tensor(0.1, device=dev)
    state = slam.odom_state
    return lambda: odometry.scan_step(state, feat.xyz, feat.mask, dt, cfg.registration,
                                      st.max_voxels, cfg.registration.k_correspondences,
                                      enable_failure_gate=cfg.registration.enable_failure_gate)


def step_ms(fn, device, iters: int = 10) -> float:
    """Mean ms of fn() over `iters` calls after a warm one: CUDA events on
    the card, the host clock elsewhere."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def step_flops(fn) -> int:
    """The FLOPs torch's FlopCounterMode counts in one fn() call."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def run(frames, cfg, warmup: int, synced: bool = False, device=None,
        peak_tflops: float = PEAK_TFLOPS) -> dict:
    """bench_pipeline.py:97-207 over `frames`: the first `warmup` scans, one
    graph solve and a timer reset, then the measured window."""
    from rolo_tpu_torch.mapping.backend import solve_graph_host
    from rolo_tpu_torch.runtime import metrics
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.runtime.slam import SlamSystem

    device = torch.device("cuda" if device is None else device)
    slam = SlamSystem(cfg, device)
    slam.sync_stages = bool(synced)

    def process(f):
        slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time)

    for f in frames[:warmup]:
        process(f)
    slam.backend_state = solve_graph_host(slam.backend_state, cfg)
    slam.timers.reset()
    _sync(device)
    t0 = time.perf_counter()
    for f in frames[warmup:]:
        process(f)
    _sync(device)
    n_measured = len(frames) - warmup
    scans_per_s = n_measured / (time.perf_counter() - t0)

    gt = torch.stack([f.gt_trans for f in frames]).cpu().numpy()
    est = slam.front_positions_np()
    ate = metrics.ate(est, gt[: est.shape[0]])
    kt, kp, _ = slam.keyframe_trajectory()  # stamps rebased to the first scan
    stamps = np.asarray([f.stamp for f in frames])
    ia, ib = metrics.associate_by_time(np.asarray(kt) + (slam._epoch or 0.0), stamps,
                                       max_diff=0.05)
    ate_kf = metrics.ate(kp[ia], gt[ib]) if len(ia) >= 3 else None
    stage = {k: {"mean_ms": round(v["mean_ms"], 3), "p50_ms": round(v["p50_ms"], 3),
                 "count": v["count"]}
             for k, v in slam.timers.summary().items() if "mean_ms" in v}

    step = frontend_step(slam, frames[-1])
    flops = step_flops(step)
    frontend_ms = step_ms(step, device)
    mfu = flops / (frontend_ms * 1e-3) / (peak_tflops * 1e12) if frontend_ms else 0.0
    db, graph = slam.backend_state.db, slam.backend_state.graph
    return {
        "metric": "pipeline_scans_per_s",
        "synced_stage_timing": bool(synced),
        "value": round(scans_per_s, 3),
        "unit": "scans/s on one GPU (end-to-end)",
        "vs_baseline": round(scans_per_s / 10.0, 4),
        "n_scans_measured": n_measured,
        "loops_enabled": bool(cfg.loop.enable),
        "priors_enabled": bool(cfg.prior.enable),
        "stage_mean_ms": stage,
        "ate_frontend_rmse_m": round(ate.rmse, 4),
        "ate_keyframes_rmse_m": round(ate_kf.rmse, 4) if ate_kf else None,
        "frontend_flops_per_step": flops,
        "frontend_flops_scope": FLOPS_SCOPE,
        "frontend_device_ms": round(frontend_ms, 3),
        "frontend_mfu_vs_peak": round(mfu, 6),
        "peak_tflops_assumed": peak_tflops,
        "drop_counts": slam.drop_counts,
        "n_keyframes": int(db.count),
        "n_loop_factors": int(graph.loops.count),
        "n_prior_factors": int(graph.priors.count),
        "machine": bench_metadata(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--peak-tflops", type=float, default=PEAK_TFLOPS,
                    help="the card's f32 peak; the FLOP share is against it")
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--no-priors", action="store_true")
    ap.add_argument("--synced", action="store_true",
                    help="each stage waits for its device work (stage times hold device time)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_pipeline.py needs a CUDA device")
    from rolo_tpu_torch.sim.dataset import generate_sequence, make_scene

    device = torch.device("cuda")
    sim = sim_config(args.warmup + args.scans, args.cols)
    frames = list(generate_sequence(sim, device, make_scene(sim, device)))
    cfg = config(loops=not args.no_loops, priors=not args.no_priors)
    print(json.dumps(run(frames, cfg, args.warmup, args.synced, device, args.peak_tflops)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

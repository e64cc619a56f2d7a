#!/usr/bin/env python3
"""Scan-to-pose latency of the PyTorch port on one NVIDIA GPU.

The counterpart of tools/bench_latency.py, with its sim, config and report:

    python tools/torch_bench_latency.py [--scans 300] [--cols 1024] [--period 24] [--seed 0]

The reference's 10 Hz design point is a latency statement: the pose of scan
t must be a host value within one scan period of the scan's arrival. Per
scan, this measures the wall time from the scan being available to its
fused pose (and its mapped pose on mapping scans) being on the host, read
in one device-to-host copy (`SlamSystem.published()`), with loops, priors,
deskew and graph solves on (`RoloConfig()`). Two feed modes, each on a
fresh system after one throwaway warm pass over the sequence:

  saturated  scan i+1 enters the moment scan i's pose is on the host;
  10 Hz      scans arrive every `sensor.scan_period` from the end of the
             warm-up; a scan that arrives while an earlier one is still
             being processed waits, and that wait is in its latency.

The first WARMUP scans of each pass run unpaced and are left out of the
statistics. Also the synced time of `solve_graph_host` at each capacity
bucket, on the saturated run's final state (loop and prior factors in the
graph). The tunnel round-trip compensation of the reference (its "local
attach" pass and every *_minus_rtt key) is left out: the card is attached
locally. Prints the report as one JSON line on stdout, beside the card's
nvidia-smi name and power limit. Needs a CUDA device; writes no file.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import List

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

WARMUP = 20  # scans run unpaced and left out of the statistics (bench_latency.py:107)
SPIKE_S = 0.5  # a latency above this records whether a solve or a loop fired
BUCKETS = (256, 512, 1024, 2048)  # bench_latency.py:272


def _percentiles(xs):
    """bench_latency.py:36-44."""
    a = np.asarray(xs, np.float64) * 1000.0
    return {
        "n": int(a.size),
        "p50_ms": round(float(np.percentile(a, 50)), 2),
        "p95_ms": round(float(np.percentile(a, 95)), 2),
        "p99_ms": round(float(np.percentile(a, 99)), 2),
        "max_ms": round(float(a.max()), 2),
    }


def sim_config(scans: int = 300, cols: int = 1024, period: float = 24.0, seed: int = 0):
    """bench_latency.py:69-71."""
    from rolo_tpu_torch.sim import SimConfig

    return SimConfig(n_scans=scans, n_cols=cols, sensor="velodyne32", period=period, seed=seed,
                     roughness=1.0, noise_std=0.02, dropout=0.05, n_boxes=14, n_cyls=24)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Drive:
    """One pass over the sequence: latencies (s) of the measured scans, all
    and split by whether the mapping cadence fired, the spikes, the
    estimate's ATE, the wall time of the whole pass, and how many paced
    scans started before their arrival (0 by construction)."""

    lat_all: List[float]
    lat_map: List[float]
    lat_plain: List[float]
    spikes: List[dict]
    ate_rmse: float
    wall: float
    early_starts: int


def drive(slam, frames, realtime_period=None, warmup: int = WARMUP, clock=time.perf_counter,
          sleep=time.sleep) -> Drive:
    """bench_latency.py:111-177: drive `frames` through `slam`, reading each
    scan's published pose on the host. realtime_period None is the saturated
    feed; a period paces arrivals from the end of the warm-up, each arrival
    computed from the anchored start (a late scan is never slept for), and
    each latency runs from arrival. `clock` and `sleep` are injectable."""
    from rolo_tpu_torch.runtime import metrics

    lat_all, lat_map, lat_plain, spikes = [], [], [], []
    prev_solves = prev_loops = early = 0
    gt_pos, est_pos = [], []
    samples = slam.timers._samples
    t_run0 = clock()
    start = None
    for i, frame in enumerate(frames):
        if realtime_period is not None and i >= warmup:
            if start is None:
                start = clock()
            arrival = start + (i - warmup) * realtime_period
            while (now := clock()) < arrival:
                sleep(arrival - now)
            t0 = arrival
        else:
            t0 = clock()
        if clock() < t0:
            early += 1
        slam.process_scan(frame.points, frame.stamp, ring=getattr(frame, "ring", None),
                          rel_time=getattr(frame, "rel_time", None))
        pose = slam.published()  # the scan's poses in one device-to-host copy
        dt = clock() - t0
        mapping = "mapped_trans" in pose
        if i >= warmup:
            lat_all.append(dt)
            (lat_map if mapping else lat_plain).append(dt)
            if dt > SPIKE_S:
                spikes.append({
                    "scan": i, "ms": round(dt * 1000, 1), "mapping": mapping,
                    "solve_fired": len(samples.get("graph_solve", ())) > prev_solves,
                    "loop_fired": len(samples.get("loop_closure", ())) > prev_loops,
                })
        prev_solves = len(samples.get("graph_solve", ()))
        prev_loops = len(samples.get("loop_closure", ()))
        est_pos.append(pose["mapped_trans"] if mapping else pose["fused_trans"])
        gt_pos.append(frame.gt_trans)
    wall = clock() - t_run0
    slam.finalize()
    gt = (torch.stack(gt_pos).cpu().numpy() if isinstance(gt_pos[0], torch.Tensor)
          else np.stack(gt_pos))
    ate = metrics.ate(np.stack(est_pos), gt).rmse
    return Drive(lat_all, lat_map, lat_plain, spikes, ate, wall, early)


def solve_ms_by_bucket(state, cfg, buckets=BUCKETS, reps: int = 3) -> dict:
    """bench_latency.py:267-287: the synced ms of `solve_graph_host` pinned
    to each capacity bucket (count_hint) on `state`: one untimed call, then
    the mean of `reps`. Every call starts from `state`'s poses (the solve
    writes the keyframe poses in place, the reference's returns new ones).
    Buckets above the store's capacity are skipped."""
    from rolo_tpu_torch.mapping.backend import solve_graph_host

    dev = state.db.rot.device

    def fresh():
        db = state.db
        return state._replace(db=db._replace(rot=db.rot.clone(), trans=db.trans.clone()))

    out = {}
    for bucket in buckets:
        if bucket > state.db.capacity:
            continue
        solve_graph_host(fresh(), cfg, count_hint=bucket)
        copies = [fresh() for _ in range(reps)]
        total = 0.0
        for copy in copies:
            _sync(dev)
            t0 = time.perf_counter()
            solve_graph_host(copy, cfg, count_hint=bucket)
            _sync(dev)
            total += time.perf_counter() - t0
        out[str(bucket)] = round(total / reps * 1000, 1)
    return out


def fetch_rtt_ms(device, reps: int = 20) -> float:
    """bench_latency.py:79-86: the mean ms of a 3-float device-to-host read."""
    x = torch.zeros(3, device=device)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        (x + 1.0).cpu()
    return (time.perf_counter() - t0) / reps * 1000.0


def measure(frames, cfg=None, device=None, warm: bool = True, buckets=BUCKETS,
            warmup: int = WARMUP, n_cols=None):
    """The report of bench_latency.py:181-289 over `frames` (without the
    rtt-compensated keys): a warm pass when `warm`, the saturated pass and
    the bucket timings on its final state, then the 10 Hz pass; one
    SlamSystem on the device at a time. Returns the report and the two
    measured passes (saturated, 10 Hz)."""
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.runtime.slam import SlamSystem

    cfg = RoloConfig() if cfg is None else cfg
    device = torch.device("cuda" if device is None else device)
    rtt_ms = fetch_rtt_ms(device)
    print(f"device fetch round trip: {rtt_ms:.3f} ms", file=sys.stderr)
    if warm:
        print(f"warm pass over {len(frames)} scans", file=sys.stderr)
        drive(SlamSystem(cfg, device), frames, warmup=warmup)
        gc.collect()

    print(f"driving {len(frames)} scans, saturated feed", file=sys.stderr)
    slam = SlamSystem(cfg, device)
    sat = drive(slam, frames, warmup=warmup)
    bucket_ms = solve_ms_by_bucket(slam.backend_state, cfg, buckets)
    del slam
    gc.collect()

    period = cfg.sensor.scan_period
    print(f"driving {len(frames)} scans at {1.0 / period:.0f} Hz arrivals", file=sys.stderr)
    rt = drive(SlamSystem(cfg, device), frames, realtime_period=period, warmup=warmup)
    gc.collect()

    def split(d: Drive):
        return {"all": _percentiles(d.lat_all),
                "mapping_scans": _percentiles(d.lat_map) if d.lat_map else None,
                "non_mapping_scans": _percentiles(d.lat_plain) if d.lat_plain else None}

    budget_ms = period * 1000.0
    report = {
        "description": __doc__.split("\n")[0],
        "workload": {
            "n_scans": len(frames), "n_cols": n_cols, "loops": cfg.loop.enable,
            "priors": cfg.prior.enable, "deskew": cfg.sensor.deskew_enabled,
            "warmup_scans_excluded": warmup,
        },
        "scan_to_pose_latency_realtime_10hz": split(rt),
        "scan_to_pose_latency_saturated": split(sat),
        "budget_ms": budget_ms,
        "env_fetch_rtt_ms": round(rtt_ms, 3),
        "meets_10hz_budget_p99_wall": bool(
            np.percentile(np.asarray(rt.lat_all) * 1000, 99) <= budget_ms),
        "synced_wall_scans_per_s": round(len(frames) / sat.wall, 3),
        "ate_rmse_m": round(sat.ate_rmse, 4),
        "latency_spikes_over_500ms": {"realtime": rt.spikes, "saturated": sat.spikes},
        "graph_solve_synced_ms_by_bucket": bucket_ms,
        "machine": bench_metadata(),
    }
    return report, sat, rt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=300)
    ap.add_argument("--cols", type=int, default=1024)
    ap.add_argument("--period", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_latency.py needs a CUDA device")
    from rolo_tpu_torch.sim.dataset import generate_sequence, make_scene

    device = torch.device("cuda")
    sim = sim_config(args.scans, args.cols, args.period, args.seed)
    frames = list(generate_sequence(sim, device, make_scene(sim, device)))
    print(json.dumps(measure(frames, device=device, n_cols=args.cols)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

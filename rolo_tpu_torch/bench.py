"""Registration benchmark of the port: scan-pair rot-GICP registrations per
second on one GPU, the counterpart of the repo's `bench.py`.

Same workload and gate: consecutive raycast scans 0.2 s apart (32-beam
sensor, 1024 columns, rough terrain, noise and dropout), features from the
projection + LOAM pipeline at `RoloConfig()` capacities, B stride-2 pairs
registered from a zero initial guess. The median rotation error must stay
below 0.75 deg and the median translation error below 0.030 m before any
rate is printed. The scans come from the port's own simulator.

    python -m rolo_tpu_torch bench        # needs a CUDA device
"""

from __future__ import annotations

import json
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from .config import RegistrationConfig, RoloConfig
from .pointcloud.cloud import PaddedCloud, concat_clouds
from .pointcloud.features import FeatureClouds, extract_features
from .pointcloud.projection import RawScan, RingImage, project_scan
from .registration.rotgicp import register_scan_pair
from .runtime.platform import bench_metadata, configure_precision
from .sim.dataset import SimConfig, SimFrame, generate_sequence

GATE_ROT_DEG = 0.75
GATE_TRANS_M = 0.030
BATCH = 16
STRIDE = 2


def bench_sim_config(n_scans: int) -> SimConfig:
    """The bench's simulator settings (bench.py:57-60)."""
    return SimConfig(n_scans=n_scans, n_cols=1024, sensor="velodyne32", period=20.0,
                     roughness=1.2, noise_std=0.02, dropout=0.05, seed=0)


def featurize_parts(frame: SimFrame, cfg: RoloConfig) -> Tuple[FeatureClouds, RingImage]:
    """Raw scan -> range image -> LOAM corners and surfaces: the feature
    clouds apart, and the range image (whose points scan-context reads)."""
    st, dev = cfg.static, frame.points.device
    cap = st.max_raw_points
    m = min(frame.points.shape[0], cap)
    xyz = torch.zeros(cap, 3, device=dev)
    ring = torch.zeros(cap, dtype=torch.int32, device=dev)
    rel = torch.zeros(cap, device=dev)
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    xyz[:m], ring[:m], rel[:m], mask[:m] = frame.points[:m], frame.ring[:m], \
        frame.rel_time[:m], True
    img = project_scan(RawScan(xyz, ring, rel, mask), cfg.sensor.n_scan, cfg.sensor.horizon_scan,
                       cfg.sensor.lidar_min_range, cfg.sensor.lidar_max_range,
                       cfg.sensor.downsample_rate)
    fc = extract_features(img, cfg.features.edge_threshold, cfg.features.surf_threshold,
                          cfg.features.odometry_surf_leaf_size, st.max_corner_points,
                          st.max_surf_points)
    return fc, img


def featurize(frame: SimFrame, cfg: RoloConfig) -> PaddedCloud:
    """Corners and surfaces stacked into one padded cloud of
    cfg.static.max_feature_points (the front-end's input)."""
    fc, _ = featurize_parts(frame, cfg)
    return concat_clouds(fc.corners, fc.surfaces, cfg.static.max_feature_points)


def gt_relative(rot_prev, trans_prev, rot_cur, trans_cur):
    """T_cur^-1 T_prev: maps prev-scan sensor points into the current frame
    (the front-end's registration direction)."""
    rel_rot = rot_cur.transpose(-1, -2) @ rot_prev
    rel_trans = (rot_cur.transpose(-1, -2) @ (trans_prev - trans_cur)[..., None])[..., 0]
    return rel_rot, rel_trans


def make_features(sim: SimConfig, cfg: RoloConfig, device) -> Tuple[List[PaddedCloud], list]:
    """Simulate and featurize every scan of `sim`: (clouds, frames)."""
    frames = list(generate_sequence(sim, device))
    return [featurize(f, cfg) for f in frames], frames


def stack_pairs(clouds: List[PaddedCloud], frames: List[SimFrame], batch: int, stride: int = 2):
    """src = scan i, tgt = scan i + stride for i < batch, with the ground
    truth relative motions."""
    src = [clouds[i] for i in range(batch)]
    tgt = [clouds[i + stride] for i in range(batch)]
    gt = [gt_relative(frames[i].gt_rot, frames[i].gt_trans, frames[i + stride].gt_rot,
                      frames[i + stride].gt_trans) for i in range(batch)]
    return (torch.stack([c.xyz for c in src]), torch.stack([c.mask for c in src]),
            torch.stack([c.xyz for c in tgt]), torch.stack([c.mask for c in tgt]),
            torch.stack([g[0] for g in gt]), torch.stack([g[1] for g in gt]))


def pose_errors(rot, trans, gt_rot, gt_trans):
    """Per-pair rotation error (deg) and translation error (m), numpy."""
    r = rot.detach().cpu().double().numpy()
    g = gt_rot.detach().cpu().double().numpy()
    cos = (np.trace(np.einsum("bij,bik->bjk", g, r), axis1=1, axis2=2) - 1) / 2
    rot_err = np.degrees(np.arccos(np.clip(cos, -1, 1)))
    trans_err = np.linalg.norm(trans.detach().cpu().double().numpy()
                               - gt_trans.detach().cpu().double().numpy(), axis=1)
    return rot_err, trans_err


def register_batch(src, src_mask, tgt, tgt_mask, guess, reg: RegistrationConfig,
                   voxel_capacity: int, k: int):
    """register_scan_pair on B pairs at the bench's 0.2 s pair interval."""
    dt = torch.full((src.shape[0],), 0.2, device=src.device)
    return register_scan_pair(src, src_mask, tgt, tgt_mask, guess, torch.zeros_like(guess),
                              dt, dt, reg, voxel_capacity, k)


_HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def profile_run(run, top: int = 12) -> dict:
    """Where one call of `run` (which must end in a synchronize) spends the
    card's time: wall time without the profiler after a warm call, then one
    torch.profiler trace for the kernels. The busy share is kernel time over
    the unprofiled wall time; `host_waits` counts the host's waits for the
    card (run's closing synchronize included) and `d2h_copies` the copies
    to the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
    by_name: dict = {}
    host_waits = d2h = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, n + 1)
            d2h += evt.name.startswith("Memcpy DtoH")
        else:
            host_waits += evt.name in _HOST_WAITS
    kernel_ms = sum(ms for ms, _ in by_name.values())
    launches = sum(n for _, n in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
            "device_launches": launches, "host_waits": host_waits, "d2h_copies": d2h,
            "top": [{"kernel": name[:90], "ms": ms, "count": n} for name, (ms, n) in rows]}


def profile_batch(src, src_mask, tgt, tgt_mask, reg: RegistrationConfig, voxel_capacity: int,
                  k: int, top: int = 12) -> dict:
    """`profile_run` of one registration batch from a zero guess."""
    guess = torch.zeros(src.shape[0], 3, device=src.device)

    def run():
        register_batch(src, src_mask, tgt, tgt_mask, guess, reg, voxel_capacity, k)
        torch.cuda.synchronize()

    return profile_run(run, top)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rolo_tpu_torch bench needs a CUDA device")
    configure_precision()
    device = torch.device("cuda")
    batch, stride = BATCH, STRIDE
    cfg = RoloConfig()
    reg = cfg.registration

    t_gen = time.perf_counter()
    clouds, frames = make_features(bench_sim_config(batch + stride), cfg, device)
    src, src_mask, tgt, tgt_mask, gt_rot, gt_trans = stack_pairs(clouds, frames, batch, stride)
    torch.cuda.synchronize()
    print(f"workload: {batch} sim scan pairs, median |gt_trans|="
          f"{float(gt_trans.norm(dim=1).median()):.2f} m, gen {time.perf_counter() - t_gen:.1f}s",
          file=sys.stderr)

    guess = torch.zeros(batch, 3, device=device)
    res = register_batch(src, src_mask, tgt, tgt_mask, guess, reg, cfg.static.max_voxels,
                         reg.k_correspondences)
    rot_err, trans_err = pose_errors(res.rot, res.trans, gt_rot, gt_trans)
    print(f"accuracy: rot_err median {np.median(rot_err):.3f} deg, "
          f"trans_err median {np.median(trans_err):.4f} m", file=sys.stderr)
    if not (np.median(rot_err) < GATE_ROT_DEG and np.median(trans_err) < GATE_TRANS_M):
        raise SystemExit(f"accuracy gate failed: {np.median(rot_err):.3f} deg, "
                         f"{np.median(trans_err):.4f} m")

    # Each timed batch starts from a 1e-6-scaled copy of the last result:
    # a data dependency between batches at zero-guess difficulty.
    iters = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        res = register_batch(src, src_mask, tgt, tgt_mask, res.trans * 1e-6, reg,
                             cfg.static.max_voxels, reg.k_correspondences)
    torch.cuda.synchronize()
    regs_per_s = batch * iters / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": "scan_registrations_per_s",
        "value": round(regs_per_s, 2),
        "unit": "registrations/s/chip",
        "vs_baseline": round(regs_per_s / 10.0, 2),
        "machine": bench_metadata(),
    }))
    return 0

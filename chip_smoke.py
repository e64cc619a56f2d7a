#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rolo_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:
  0. device: a CUDA device is required (nothing falls back to the CPU);
     full-f32 precision; the card's nvidia-smi name and power limit.
  1. build both CUDA kernels from rolo_tpu_torch/csrc with nvcc (sm_90a).
  2. each kernel against its plain torch version on the card, at the main
     path's shapes (B=16, 8192 feature points, RoloConfig() capacities):
     errors with their tolerance, and warm median times (CUDA events).
  3. the main path, the bench workload: simulated 32-beam scans ->
     featurize -> register_scan_pair on 16 stride-2 pairs from a zero guess.
     The bench gate (median < 0.75 deg and < 0.030 m) must hold, and both
     kernels' launch counters must rise during this run. Then the rate, and
     one batch under torch.profiler: the card's busy share and top kernels.
  4. front-end odometry (run_sequence) over consecutive scans of the same
     simulation: ATE against ground truth, and the per-step relative error
     held to the same gate.
Then one JSON line lists each kernel: its launches in phase 3's main-path
run, and from phase 2 its worst max_abs_err and its ms / plain_ms summed
over its cases (one call of each; every case is also under "cases").
The line before the last is the card's `nvidia-smi` name and power limit;
the last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from rolo_tpu_torch import bench
from rolo_tpu_torch.config import RoloConfig
from rolo_tpu_torch.frontend.odometry import run_sequence
from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_moments import knn_moments, knn_moments_torch
from rolo_tpu_torch.ops.voxel_join import (INVALID_PACK, keyed_matmul, keyed_matmul_torch,
                                           pack_polar, pack_uniform)
from rolo_tpu_torch.registration.gicp import OFFSETS
from rolo_tpu_torch.runtime.platform import configure_precision, nvidia_smi_name_power
from rolo_tpu_torch.voxel.knn import estimate_cov6, moment_table
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map, polar_coord, uniform_coord

BATCH, STRIDE = bench.BATCH, bench.STRIDE
N_SEQ = 24  # consecutive scans for the odometry phase (>= BATCH + STRIDE)
# max |kernel - plain| per output plane, relative to max(1, max |plain|) of
# that plane: both sum the same f32 terms in different orders.
REL_TOL = 1e-5
KERNELS = {
    "keyed_sum": {"route": "cuda", "source": "rolo_tpu_torch/csrc/keyed_sum.cu",
                  "replaces": "rolo_tpu/ops/voxel_join.py:151"},
    "knn_moments": {"route": "cuda", "source": "rolo_tpu_torch/csrc/knn_moments.cu",
                    "replaces": "rolo_tpu/ops/knn_moments.py:169"},
}


def cuda_ms(fn, reps: int) -> float:
    """Warm median milliseconds of fn() on the current stream."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def plane_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = torch.clamp(want.abs().amax(dim=-1, keepdim=True), min=1.0)
    return float(((got - want).abs() / scale).max())


def kernel_cases(cfg: RoloConfig, src, src_mask, tgt, tgt_mask):
    """(kernel, case, kernel_fn, plain_fn) at the main path's shapes, built
    from the workload's own feature clouds."""
    reg = cfg.registration
    polar = tuple(reg.polar_resolution)
    tgt_cov = estimate_cov6(tgt, tgt_mask, k=reg.k_correspondences)
    w = tgt_mask.float()
    data = torch.cat([w[:, None], tgt.transpose(1, 2) * w[:, None], tgt_cov * w[:, None]],
                     1).contiguous()
    pack = torch.where(tgt_mask, pack_polar(polar_coord(tgt, polar)), INVALID_PACK)
    pack = pack.to(torch.int32).contiguous()
    table = torch.sort(pack, dim=-1).values.contiguous()
    vmap = build_voxel_map(tgt, tgt_cov, tgt_mask, cfg.static.max_voxels, polar_res=polar)
    q1 = torch.where(src_mask, pack_polar(polar_coord(src, polar)), INVALID_PACK)
    q1 = q1.to(torch.int32).contiguous()
    fine = build_voxel_map(tgt, tgt_cov, tgt_mask, cfg.static.max_voxels, polar_res=None,
                           resolution=reg.ct_fine_resolution)
    c = uniform_coord(src, reg.ct_fine_resolution)
    off = torch.tensor(OFFSETS[reg.ct_fine_neighbors], dtype=torch.int32, device=src.device)
    q7 = pack_uniform(c[:, None, :, :] + off[None, :, None, :])
    q7 = torch.where(src_mask[:, None], q7, INVALID_PACK).to(torch.int32)
    q7 = q7.reshape(src.shape[0], -1).contiguous()
    xyz = torch.where(tgt_mask[..., None], tgt, 0.0).contiguous()
    xc = moment_table(xyz, tgt_mask).contiguous()
    k = reg.k_correspondences
    return [
        ("keyed_sum", f"build [10,{pack.shape[1]}]->{table.shape[1]}",
         lambda: keyed_matmul(data, pack, table), lambda: keyed_matmul_torch(data, pack, table)),
        ("keyed_sum", f"join polar M={q1.shape[1]}",
         lambda: keyed_matmul(vmap.stats, vmap.pack, q1, keys_sorted=True),
         lambda: keyed_matmul_torch(vmap.stats, vmap.pack, q1)),
        ("keyed_sum", f"join fine direct7 M={q7.shape[1]}",
         lambda: keyed_matmul(fine.stats, fine.pack, q7, keys_sorted=True),
         lambda: keyed_matmul_torch(fine.stats, fine.pack, q7)),
        ("knn_moments", f"Q=N={xyz.shape[1]} k={k}",
         lambda: knn_moments(xyz, tgt_mask, xyz, tgt_mask, xc, k),
         lambda: knn_moments_torch(xyz, tgt_mask, xyz, tgt_mask, xc, k)),
    ]


def check_kernels(cases, reps: int = 5, timer=cuda_ms) -> dict:
    """Phase 2: kernel vs plain on identical inputs; per-kernel summary."""
    summary = {}
    for name, case, kern, plain in cases:
        got, want = kern(), plain()
        err = plane_rel_err(got, want)
        max_abs = float((got - want).abs().max())
        ms, plain_ms = timer(kern, reps), timer(plain, max(1, reps // 2))
        print(f"kernel {name} [{case}]: max_abs_err {max_abs:.3e}, rel err {err:.3e} "
              f"(tol {REL_TOL:g}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not err <= REL_TOL:
            raise AssertionError(f"{name} [{case}] disagrees with its plain version: {err:.3e}")
        if name == "knn_moments" and not torch.equal(got[:, 0], want[:, 0]):
            raise AssertionError("knn_moments membership counts differ from the plain version")
        s = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                      "cases": []})
        s["max_abs_err"] = max(s["max_abs_err"], max_abs)
        s["ms"] += ms
        s["plain_ms"] += plain_ms
        s["cases"].append({"case": case, "max_abs_err": max_abs, "rel_err": err, "ms": ms,
                           "plain_ms": plain_ms})
    return summary


def main_path(cfg: RoloConfig, src, src_mask, tgt, tgt_mask, gt_rot, gt_trans,
              timed_reps: int = 3):
    """Phase 3: the bench workload through the port, with launch counts."""
    reg = cfg.registration
    guess = torch.zeros(src.shape[0], 3, device=src.device)
    sync = torch.cuda.synchronize if src.is_cuda else (lambda: None)
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    res = bench.register_batch(src, src_mask, tgt, tgt_mask, guess, reg, cfg.static.max_voxels,
                               reg.k_correspondences)
    sync()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    rot_err, trans_err = bench.pose_errors(res.rot, res.trans, gt_rot, gt_trans)
    if not (np.isfinite(rot_err).all() and np.isfinite(trans_err).all()):
        raise AssertionError("non-finite registration result")
    print(f"main path: {src.shape[0]} pairs, rot_err median {np.median(rot_err):.4f} deg "
          f"(max {rot_err.max():.4f}), trans_err median {np.median(trans_err):.5f} m "
          f"(max {trans_err.max():.5f}), rot iters {res.rot_iterations.tolist()}, "
          f"ct iters {res.ct_iterations.tolist()}, launches {launches}")
    if not np.median(rot_err) < bench.GATE_ROT_DEG:
        raise AssertionError(f"bench gate: median rot err {np.median(rot_err):.4f} deg")
    if not np.median(trans_err) < bench.GATE_TRANS_M:
        raise AssertionError(f"bench gate: median trans err {np.median(trans_err):.5f} m")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    t0 = time.perf_counter()
    for _ in range(timed_reps):
        res = bench.register_batch(src, src_mask, tgt, tgt_mask, res.trans * 1e-6, reg,
                                   cfg.static.max_voxels, reg.k_correspondences)
    sync()
    rate = src.shape[0] * timed_reps / (time.perf_counter() - t0)
    return launches, float(np.median(rot_err)), float(np.median(trans_err)), rate


def odometry(cfg: RoloConfig, clouds, frames, interval: float = 0.1):
    """Phase 4: run_sequence over consecutive scans vs ground truth."""
    reg = cfg.registration
    xyz = torch.stack([c.xyz for c in clouds])
    mask = torch.stack([c.mask for c in clouds])
    t0 = time.perf_counter()
    out = run_sequence(xyz, mask, torch.full((len(clouds),), interval, device=xyz.device), reg,
                       cfg.static.max_voxels, reg.k_correspondences)
    pose_rot, pose_trans = out.pose_rot.cpu().double(), out.pose_trans.cpu().double()
    seconds = time.perf_counter() - t0
    if not (torch.isfinite(pose_rot).all() and torch.isfinite(pose_trans).all()):
        raise AssertionError("non-finite odometry poses")
    g_rot = torch.stack([f.gt_rot for f in frames]).cpu().double()
    g_trans = torch.stack([f.gt_trans for f in frames]).cpu().double()
    # ground truth of frame i in frame 0's sensor coordinates
    gt_trans0 = (g_rot[0].T @ (g_trans - g_trans[0]).T).T
    ate = float(torch.sqrt(((pose_trans - gt_trans0) ** 2).sum(-1).mean()))
    step_gt = bench.gt_relative(g_rot[:-1], g_trans[:-1], g_rot[1:], g_trans[1:])
    rot_err, trans_err = bench.pose_errors(out.step_rot[1:], out.step_trans[1:], *step_gt)
    print(f"odometry: {len(clouds)} scans in {seconds:.2f} s, ATE {ate:.4f} m over "
          f"{float(gt_trans0[-1].norm()):.2f} m, step err median {np.median(rot_err):.4f} deg / "
          f"{np.median(trans_err):.5f} m")
    if not (np.median(rot_err) < bench.GATE_ROT_DEG and np.median(trans_err) < bench.GATE_TRANS_M):
        raise AssertionError("odometry per-step error outside the bench gate")
    return ate, float(np.median(rot_err)), float(np.median(trans_err))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is false)")
    configure_precision()
    smi = nvidia_smi_name_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"nvidia-smi: {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    for name in KERNELS:
        path, seconds = cuda_build.build(name)
        print(f"build {name}: {seconds:.1f} s -> {path.name}")
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    cfg = RoloConfig()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    clouds, frames = bench.make_features(bench.bench_sim_config(N_SEQ), cfg, device)
    pairs = bench.stack_pairs(clouds, frames, BATCH, STRIDE)
    torch.cuda.synchronize()
    print(f"workload: {N_SEQ} sim scans featurized in {time.perf_counter() - t0:.1f} s, "
          f"valid features per scan {[int(c.mask.sum()) for c in clouds[:BATCH + STRIDE]]}")

    summary = check_kernels(kernel_cases(cfg, *pairs[:4]))
    launches, rot_med, trans_med, rate = main_path(cfg, *pairs)
    print(f"registrations/s: {rate:.2f} at B={BATCH} on {smi} "
          f"(gate medians {rot_med:.4f} deg, {trans_med:.5f} m)")
    reg = cfg.registration
    prof = bench.profile_batch(*pairs[:4], reg, cfg.static.max_voxels, reg.k_correspondences)
    print(f"profile of one batch: {json.dumps(prof)}")
    odometry(cfg, clouds, frames)

    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name], **summary[name]}
        for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

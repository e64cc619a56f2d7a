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
  5. mapping: N_MAP consecutive scans at RoloConfig() capacities; scan_step
     (both kernels) on every scan, backend_step whenever the 0.15 s mapping
     cadence fires (as runtime/slam.py does), then one solve_graph_host.
     Raises unless every pose is finite, at least 10 keyframes were added,
     every optimized step had >= 50 factors, both kernels' launch counters
     rose, and the mapped keyframes' ATE is no worse than the front-end's
     over the same scans.
Then one JSON line lists each kernel: its launches in phase 3's main-path
run (and in phase 5's, "launches_mapping"), and from phase 2 its worst
max_abs_err and its ms / plain_ms summed over its cases (one call of each;
every case is also under "cases"; the B=1 cases are the shapes of phases 4
and 5).
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
from rolo_tpu_torch.frontend.odometry import init_state, run_sequence, scan_step
from rolo_tpu_torch.mapping.backend import backend_step, init_backend, solve_graph_host
from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_moments import knn_moments, knn_moments_torch
from rolo_tpu_torch.ops.voxel_join import (INVALID_PACK, keyed_matmul, keyed_matmul_torch,
                                           pack_polar, pack_uniform)
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds
from rolo_tpu_torch.registration.gicp import OFFSETS
from rolo_tpu_torch.runtime.platform import configure_precision, nvidia_smi_name_power
from rolo_tpu_torch.sim.dataset import generate_sequence
from rolo_tpu_torch.voxel.knn import estimate_cov6, moment_table
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map, polar_coord, uniform_coord

BATCH, STRIDE = bench.BATCH, bench.STRIDE
N_SEQ = 24  # consecutive scans for the odometry phase (>= BATCH + STRIDE)
N_MAP = 60  # consecutive scans for the mapping phase
MIN_KEYFRAMES = 10
MIN_FACTORS = 50  # scan2map's min_factors (rolo_tpu/mapping/scan2map.py:273)
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


def _ate(trans: torch.Tensor, frames) -> float:
    """RMS position error against ground truth in frame 0's coordinates."""
    g_rot = torch.stack([f.gt_rot for f in frames]).cpu().double()
    g_trans = torch.stack([f.gt_trans for f in frames]).cpu().double()
    gt0 = (g_rot[0].T @ (g_trans - g_trans[0]).T).T
    return float(torch.sqrt(((trans.cpu().double() - gt0) ** 2).sum(-1).mean()))


def mapping(cfg: RoloConfig, frames, interval: float = 0.1):
    """Phase 5: the mapping back-end fed by the front-end, scan by scan, as
    runtime/slam.py:333-384 drives it, then the bucketed graph solve. The
    frames start at scan 0, so "frame 0's coordinates" are the map's."""
    reg, st = cfg.registration, cfg.static
    feats = [bench.featurize_parts(f, cfg) for f in frames]
    sync = torch.cuda.synchronize if frames[0].points.is_cuda else (lambda: None)
    front = init_state(st.max_feature_points, frames[0].points.device)
    state = init_backend(cfg, frames[0].points.device)
    front_trans, steps = [], []
    last = -float("inf")
    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t_run = time.perf_counter()
    for i, (fc, img) in enumerate(feats):
        feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)
        front, fo = scan_step(front, feat.xyz, feat.mask, interval, reg, st.max_voxels,
                              reg.k_correspondences, enable_failure_gate=reg.enable_failure_gate)
        front_trans.append(fo.pose_trans)
        stamp = i * interval
        if stamp - last >= cfg.mapping.mapping_process_interval:
            last = stamp
            raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
            sc_cloud = raw if cfg.loop.sc_input_type == "scan_raw" else fc.surfaces
            sync()
            t0 = time.perf_counter()
            state, out = backend_step(state, fc.corners, fc.surfaces, sc_cloud, fo.pose_rot,
                                      fo.pose_trans, True, stamp, cfg)
            sync()
            steps.append((i, out, (time.perf_counter() - t0) * 1e3))
    t0 = time.perf_counter()
    state = solve_graph_host(state, cfg, count_hint=len(steps))
    sync()
    solve_ms = (time.perf_counter() - t0) * 1e3
    seconds = time.perf_counter() - t_run
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    # the same solve again, warm (the first call pays torch.func's and the
    # linear-algebra libraries' first-use costs); the graph is now solved
    t0 = time.perf_counter()
    solve_graph_host(state._replace(db=state.db._replace(rot=state.db.rot.clone(),
                                                         trans=state.db.trans.clone())),
                     cfg, count_hint=len(steps))
    sync()
    warm_solve_ms = (time.perf_counter() - t0) * 1e3

    kf_scans = [i for i, out, _ in steps if bool(out.keyframe_added)]
    n_kf = int(state.db.count)
    iters = [int(out.s2m_iterations) for _, out, _ in steps]
    nfac = [int(out.num_factors) for _, out, _ in steps]
    degen = [int(bool(out.degenerate)) for _, out, _ in steps]
    step_ms = [ms for _, _, ms in steps[2:]]  # after the first step and a warm optimizing one
    kf_frames = [frames[i] for i in kf_scans]
    front_ate = _ate(torch.stack([front_trans[i] for i in kf_scans]), kf_frames)
    map_ate = _ate(state.db.trans[:n_kf], kf_frames)
    print(f"mapping: {len(frames)} scans in {seconds:.2f} s, {len(steps)} mapping steps, "
          f"{n_kf} keyframes added (scans {kf_scans})")
    print(f"mapping: s2m_iterations {iters}")
    print(f"mapping: num_factors {nfac}")
    print(f"mapping: degenerate {degen}")
    print(f"mapping: backend_step wall ms median {statistics.median(step_ms):.2f} "
          f"max {max(step_ms):.2f} over {len(step_ms)} steps; solve_graph_host {solve_ms:.2f} ms "
          f"cold, {warm_solve_ms:.2f} ms warm ({n_kf} keyframes)")
    print(f"mapping: ATE over the {n_kf} keyframe scans: front-end {front_ate:.4f} m, "
          f"mapped keyframes {map_ate:.4f} m; launches {launches}")
    poses = torch.cat([state.db.rot[:n_kf].reshape(-1), state.db.trans[:n_kf].reshape(-1),
                       torch.stack(front_trans).reshape(-1), state.xyz, state.rpy])
    if not bool(torch.isfinite(poses).all()):
        raise AssertionError("non-finite mapping poses")
    if n_kf != len(kf_scans) or n_kf < MIN_KEYFRAMES:
        raise AssertionError(f"mapping added {n_kf} keyframes (need >= {MIN_KEYFRAMES})")
    starved = [(i, n) for (i, out, _), n in zip(steps[1:], nfac[1:]) if n < MIN_FACTORS]
    if starved:
        raise AssertionError(f"optimized steps with < {MIN_FACTORS} factors: {starved}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the mapping path")
    if not map_ate <= front_ate:
        raise AssertionError(f"mapped keyframe ATE {map_ate:.4f} m exceeds the front-end's "
                             f"{front_ate:.4f} m over the same scans")
    if frames[0].points.is_cuda:
        # one more step of the last mapped scan, traced (it rewrites the DB
        # row past the count: the state above is not advanced)
        i = steps[-1][0]
        fc, img = feats[i]
        raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
        rot, trans = state.db.rot[n_kf - 1], state.db.trans[n_kf - 1]

        def run():
            backend_step(state, fc.corners, fc.surfaces, raw, rot, trans, True, i * interval, cfg)
            sync()

        print(f"profile of one backend_step: {json.dumps(bench.profile_run(run))}")
    return launches, front_ate, map_ate


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

    cases = kernel_cases(cfg, *pairs[:4])
    cases += [(name, f"B=1 {case}", kern, plain)
              for name, case, kern, plain in kernel_cases(cfg, *(t[:1] for t in pairs[:4]))]
    summary = check_kernels(cases)
    launches, rot_med, trans_med, rate = main_path(cfg, *pairs)
    print(f"registrations/s: {rate:.2f} at B={BATCH} on {smi} "
          f"(gate medians {rot_med:.4f} deg, {trans_med:.5f} m)")
    reg = cfg.registration
    prof = bench.profile_batch(*pairs[:4], reg, cfg.static.max_voxels, reg.k_correspondences)
    print(f"profile of one batch: {json.dumps(prof)}")
    odometry(cfg, clouds, frames)
    del clouds, frames, pairs
    map_frames = list(generate_sequence(bench.bench_sim_config(N_MAP), device))
    map_launches, _, _ = mapping(cfg, map_frames)

    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "launches_mapping": map_launches[name], **summary[name]}
        for name in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

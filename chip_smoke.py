#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rolo_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:
  0. device: a CUDA device is required (nothing falls back to the CPU);
     full-f32 precision; the card's nvidia-smi name and power limit.
  1. build both CUDA kernels from rolo_tpu_torch/csrc with nvcc (sm_90a).
  2. each kernel against its plain torch version on the card, at the main
     path's shapes (B=16, 8192 feature points, RoloConfig() capacities):
     errors with their tolerance (K2's count plane bit for bit), the same
     bits from a second call, and warm medians: the kernel's device time
     per call (replayed CUDA graph) and one call's event time with its
     enqueue, the plain version's, the bound from the case's inputs (H100
     peaks) with its share, the one PyTorch call that computes the same
     function where there is one (`library_ms`, timed like the kernel), and
     the sort inside the build's and K2's times (`parts_ms`).
  3. the main path, the bench workload: simulated 32-beam scans ->
     featurize -> register_scan_pair on 16 stride-2 pairs from a zero guess.
     The bench gate (median < 0.75 deg and < 0.030 m) must hold, and both
     kernels' launch counters must rise during this run. Then the rate, and
     one batch under torch.profiler: the card's busy share and top kernels.
  4. front-end odometry (run_sequence) over consecutive scans of the same
     simulation: ATE against ground truth, and the per-step relative error
     held to the same gate.
  5. one lap of the SLAM loop: N_MAP consecutive scans (the 20 s ellipse
     and 4 s past the start) at RoloConfig() capacities with loop closure,
     the ground priors and the ESKF on, every step in runtime/slam.py's
     order (see `mapping`). Raises unless every pose is finite, at least 10
     keyframes were added, every optimized step had >= 50 factors, both
     kernels' launch counters rose, at least one loop factor (endpoints at
     least sc_num_exclude_recent keyframes apart) and one prior factor were
     accepted, a graph solve ran with both in the graph, and the mapped
     keyframes' ATE after the final solve is no worse than the front-end's.
     Then one traced loop_closure_step, prior cycle and backend_step, and
     the loop ICP's Kabsch step beside its 1-NN search.
  6. the runtime lap: `run_frames(SlamSystem(RoloConfig()), frames)` over
     phase 5's frames, the user's entry point: deskew on (the default),
     the ESKF, the live ground map and priors, loop closure, and the
     runtime's own scheduler (at most one queued background task per scan).
     Raises unless every pose is finite, at least 10 keyframes were added,
     at least one loop and one prior factor were accepted and a solve ran
     with both in the graph, the mapped keyframes' ATE after finalize is no
     worse than the front-end's, both kernels' launch counters rose, and no
     scan dispatched more than one queued task. Prints the wall time per
     process_scan (synced at the fused-pose fetch; mapping and other scans
     apart), scans/s, the stage timers and the tasks per scan, and
     solve_graph_host's synced ms at buckets 256-2,048 on the lap's final
     state, loop and prior factors in the graph (the latency tool's
     `solve_ms_by_bucket`). Then
     checkpoint -> fresh SlamSystem.restore -> the next scan: under torch's
     default algorithms the original and a restored system, and two
     restored systems, must give bit-equal poses; under deterministic
     algorithms two more restored systems must too.
  7. the command line on recorded data: `python -m rolo_tpu_torch run` on
     the bag fixture in a subprocess, on the card (which builds librolo_host
     with g++): rc 0, 12 scans, front-end ATE < 0.5 m, the exports present.
  8. the parallel slice on a one-rank NCCL group at RoloConfig() width, each
     step timed (`parallel_slice`): (a) registration_batch on phase 3's
     pairs, bit-equal to register_scan_pair; (b) register_scan_pair_spmd on
     one pair, within 2e-4 / 2e-3 of register_scan_pair and inside the
     bench gate; (c) register_se3 and (d) register_multipoint (k = 8) on a
     consecutive pair inside the bench gate, from the identity or the
     constant-velocity guess; (e) odometry_batch over two sequences of
     phase 4's scans, each bit-equal to its run_sequence; (f)
     prior_solve_batch of 16 keyframe poses on phase 6's live ground map,
     each bit-equal to solve_pose; (g) dryrun_multichip(1); (h) a
     GenericEKF predict + update_iterated within 1e-5 of the CPU's.
  9. batched offline mapping (`batch_mapping`): phase 5's frames as 16
     sequences of 15 scans, the front-end through odometry_batch, one
     batched backend_step a step at the 0.15 s cadence, batched dense, bcr
     and pcg (chain and Jacobi preconditioners) solves and a batched
     solve_graph_host, every step and solve bit-equal to the sequences run
     one at a time; keyframe, accuracy and solve gates (pcg and bcr within
     1e-4 m of dense); mapped scans/s and solves/s batched and looped, and
     solve_graph_host's ms at buckets 256-2,048.
 10. the measuring tools (`latency_and_pipeline`): tools/torch_bench_latency.py's
     saturated and 10 Hz feeds over 40 scans of its sim (20 measured, no
     warm pass), gated on 20 finite latencies a mode, no paced scan
     started before its arrival, ATE < 1.0 m and both kernels launched;
     then tools/torch_bench_pipeline.py at --warmup 10 --scans 20. Both
     reports print as JSON lines.
 11. the stage profilers and diagnostics (`profiles_and_diagnostics`):
     tools/torch_profile_{frontend,stages,build,backend,projection}.py at
     RoloConfig() widths with few calls a row (each stage row: wall ms, and
     one traced call's kernel ms, launches, host waits and top kernels),
     tools/torch_diag_{dense_solve,graphsolve}.py at buckets 256 and 2,048
     (graphsolve's pcg at 256 only),
     torch_diag_ct.py on 4 bench pairs and torch_diag_prior.py over 20
     scans; every row finite, both kernels launched by the profilers, bcr
     and pcg within 1 mm of a finite dense solution and within a fifth of
     their start's error, the prior funnels narrowing to the run's prior
     factors. Each report prints as a JSON line.
 12. the multi-rank paths on the card (`multirank`): two spawned ranks, a
     card each over NCCL where the machine has two, else both on card 0
     over gloo (printed), each pinned to its card by distributed_init: (a)
     registration_batch of its 8 of phase 3's pairs bit-equal to the
     one-process batch's rows; (b) register_scan_pair_spmd over both ranks
     on phase 8 (b)'s pair within 2e-4 / 2e-3 of register_scan_pair and
     inside the bench gate, the same bits in both ranks; (c)
     dryrun_multichip(2); (d) both kernels launched in every rank; (e)
     tools/torch_bench_weak_2proc.py at its defaults and
     tools/torch_bench_scaling.py at --ranks 2 --repeats 1, each row a JSON
     line, every number finite and > 0. A rank's non-zero exit or a group
     that hangs past its timeout fails the phase.
Then one JSON line lists each kernel: its launches in phase 3's main-path
run (and in phase 5's, "launches_mapping", and per lap scan; in phase
6's, "launches_runtime"; in phase 8's, "launches_parallel"; in phase 9's,
"launches_batch_mapping"; in phase 10's latency passes,
"launches_latency"; in phase 11's profilers, "launches_profile"; in each
of phase 12's ranks, "launches_multirank"), and from phase
2 its worst max_abs_err and its
ms / plain_ms / bound_ms summed over its cases (one call of each;
library_ms only where every case has one; every case is also under
"cases"; the B=1 cases are the shapes of phases 4-6).
The line before the last is the card's `nvidia-smi` name and power limit;
the last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rolo_tpu_torch import bench
from rolo_tpu_torch.bench import graph_ms
from rolo_tpu_torch.config import RoloConfig
from rolo_tpu_torch.filter import manifold
from rolo_tpu_torch.filter.fusion import (fused_pose, init_fusion, on_front_odometry,
                                          on_mapping_odometry)
from rolo_tpu_torch.frontend.odometry import init_state, run_sequence, scan_step
from rolo_tpu_torch.geometry import so3
from rolo_tpu_torch.graft_entry import dryrun_multichip
from rolo_tpu_torch.loop.closure import detect_loop_distance, kabsch_rotation
from rolo_tpu_torch.loop.scancontext import detect_loop
from rolo_tpu_torch.mapping import backend as backend_module
from rolo_tpu_torch.graph.solver import solve_pose_graph
from rolo_tpu_torch.mapping.backend import (backend_step, init_backend, loop_closure_step,
                                            solve_graph_host)
from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_moments import knn_moments, knn_moments_torch, morton_order
from rolo_tpu_torch.ops.pytree import tree_index, tree_leaves
from rolo_tpu_torch.ops.voxel_join import (INVALID_PACK, keyed_matmul, keyed_matmul_torch,
                                           pack_polar, pack_uniform)
from rolo_tpu_torch.parallel import (odometry_batch, prior_solve_batch, register_scan_pair_spmd,
                                     registration_batch, shard_registration_inputs)
from rolo_tpu_torch.parallel import launch
from rolo_tpu_torch.parallel.mesh import distributed_init, make_mesh
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds
from rolo_tpu_torch.prior.ground import init_live_ground
from rolo_tpu_torch.prior.vehicle import from_config as vehicle_from_config
from rolo_tpu_torch.prior.vehicle import solve_pose
from rolo_tpu_torch.registration.experimental import make_problem, register_multipoint
from rolo_tpu_torch.registration.gicp import OFFSETS
from rolo_tpu_torch.registration.rotgicp import register_scan_pair, register_se3
from rolo_tpu_torch.runtime.cycles import ground_update, prior_cycle
from rolo_tpu_torch.runtime.dataset import run_frames
from rolo_tpu_torch.runtime.platform import configure_precision, nvidia_smi_name_power
from rolo_tpu_torch.runtime.slam import SlamSystem
from rolo_tpu_torch.sim.dataset import generate_sequence, ground_map_points, make_scene
from rolo_tpu_torch.voxel.knn import estimate_cov6, knn_indices, moment_table
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map, polar_coord, uniform_coord

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, STRIDE = bench.BATCH, bench.STRIDE
N_SEQ = 24  # consecutive scans for the odometry phase (>= BATCH + STRIDE)
N_MAP = 240  # consecutive scans for the mapping phase: one lap of the 20 s ellipse and 4 s
MIN_KEYFRAMES = 10
MIN_FACTORS = 50  # scan2map's min_factors (rolo_tpu/mapping/scan2map.py:273)
# max |kernel - plain| per output plane, relative to max(1, max |plain|) of
# that plane: both sum the same f32 terms in different orders.
REL_TOL = 1e-5
# NVIDIA's published H100 SXM peaks (at its 700 W limit): f32 outside the
# tensor cores, and HBM3 bandwidth; phase 2 states each kernel's bound with them
H100_F32_FLOPS = 67e12
H100_BYTES_PER_S = 3.35e12
KERNELS = {
    "keyed_sum": {"route": "cuda", "source": "rolo_tpu_torch/csrc/keyed_sum.cu",
                  "replaces": "rolo_tpu/ops/voxel_join.py:151"},
    "knn_moments": {"route": "cuda", "source": "rolo_tpu_torch/csrc/knn_moments.cu",
                    "replaces": "rolo_tpu/ops/knn_moments.py:169"},
}


def cuda_ms(fn, reps: int) -> float:
    """Warm median milliseconds of one fn() call between two CUDA events:
    the device time plus whatever of the host's enqueue it waits for."""
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


def bound_ms(flops: float, nbytes: float):
    """(least ms the card could take, "operations" or "bytes"): the larger
    of the f32 work at H100_F32_FLOPS and the bytes moved (each input read
    once, each output written once) at H100_BYTES_PER_S."""
    t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_cases(cfg: RoloConfig, src, src_mask, tgt, tgt_mask):
    """Each kernel case at the main path's shapes, built from the workload's
    own feature clouds: name, case, kernel and plain callables, the bound
    from this case's inputs, and the one PyTorch call that computes the same
    function (or why there is none)."""
    reg = cfg.registration
    polar = tuple(reg.polar_resolution)
    tgt_cov = estimate_cov6(tgt, tgt_mask, k=reg.k_correspondences)
    w = tgt_mask.float()
    data = torch.cat([w[:, None], tgt.transpose(1, 2) * w[:, None], tgt_cov * w[:, None]],
                     1).contiguous()
    pack = torch.where(tgt_mask, pack_polar(polar_coord(tgt, polar)), INVALID_PACK)
    pack = pack.to(torch.int32).contiguous()
    table = torch.sort(pack, dim=-1).values.contiguous()

    def build():  # build_voxel_map's K1 part: one sort, one gather, run sums
        sp, order = torch.sort(pack, dim=-1, stable=True)
        return keyed_matmul(torch.gather(data, 2, order[:, None].expand_as(data)), sp, sp,
                            keys_sorted=True)

    # the library yardstick of the build: index_add_ of the value columns
    # into their table slots, the slot of each point computed beforehand
    b, s, n = data.shape
    slot = torch.searchsorted(table, pack)
    flat = torch.where(tgt_mask, slot + n * torch.arange(b, device=pack.device)[:, None], b * n)
    flat, rows = flat.reshape(-1), data.transpose(1, 2).reshape(-1, s).contiguous()

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
    no_join = "none: a join is a searchsorted and a gather, no one PyTorch call"

    def join(vm, q):  # the table's stats and keys, the queries, the [B, S, M] output
        return bound_ms(0.0, _nbytes(vm.stats, vm.pack, q) + 4 * vm.stats.shape[1] * q.numel())

    n_valid = tgt_mask.sum(dim=1).double()
    pairs = float((n_valid * n_valid).sum())  # valid queries x valid candidates
    # the first half of the points as the queries, against all of them: the
    # source shard of register_scan_pair_spmd on two ranks
    q_shard = xyz[:, :xyz.shape[1] // 2].contiguous()
    qm_shard = tgt_mask[:, :xyz.shape[1] // 2].contiguous()
    shard_pairs = float((qm_shard.sum(dim=1).double() * n_valid).sum())
    return [
        {"name": "keyed_sum", "case": f"build [10,{n}]->{n} (sort included)",
         "kernel": build, "plain": lambda: keyed_matmul_torch(data, pack, table),
         "bound": bound_ms(0.0, _nbytes(data, pack, table) + _nbytes(data)),
         "library": lambda: torch.zeros(b * n + 1, s, device=data.device).index_add_(0, flat,
                                                                                      rows),
         "library_note": "zeros + index_add_ of the value columns into their slots "
                         "(the slot computation excluded)",
         "parts": {"torch.sort": lambda: torch.sort(pack, dim=-1, stable=True)}},
        {"name": "keyed_sum", "case": f"join polar M={q1.shape[1]}",
         "kernel": lambda: keyed_matmul(vmap.stats, vmap.pack, q1, keys_sorted=True,
                                        run_heads=True),
         "plain": lambda: keyed_matmul_torch(vmap.stats, vmap.pack, q1),
         "bound": join(vmap, q1), "library": None, "library_note": no_join},
        {"name": "keyed_sum", "case": f"join fine direct7 M={q7.shape[1]}",
         "kernel": lambda: keyed_matmul(fine.stats, fine.pack, q7, keys_sorted=True,
                                        run_heads=True),
         "plain": lambda: keyed_matmul_torch(fine.stats, fine.pack, q7),
         "bound": join(fine, q7), "library": None, "library_note": no_join},
        {"name": "knn_moments", "case": f"Q=N={xyz.shape[1]} k={k}",
         "kernel": lambda: knn_moments(xyz, tgt_mask, xyz, tgt_mask, xc, k),
         "plain": lambda: knn_moments_torch(xyz, tgt_mask, xyz, tgt_mask, xc, k),
         "bound": bound_ms(8.0 * pairs, _nbytes(xyz, tgt_mask, xyz, tgt_mask, xc)
                           + 4 * xc.shape[0] * xc.shape[1] * xyz.shape[1]),
         "library": None,
         "library_note": "none: no PyTorch call selects k neighbours and sums their moments",
         "parts": {"Morton order": lambda: morton_order(xyz, tgt_mask)}},
        {"name": "knn_moments", "case": f"Q={q_shard.shape[1]} of N={xyz.shape[1]} k={k} "
                                         "(an SPMD shard at D=2)",
         "kernel": lambda: knn_moments(q_shard, qm_shard, xyz, tgt_mask, xc, k),
         "plain": lambda: knn_moments_torch(q_shard, qm_shard, xyz, tgt_mask, xc, k),
         "bound": bound_ms(8.0 * shard_pairs, _nbytes(q_shard, qm_shard, xyz, tgt_mask, xc)
                           + 4 * xc.shape[0] * xc.shape[1] * q_shard.shape[1]),
         "library": None,
         "library_note": "none: no PyTorch call selects k neighbours and sums their moments",
         "parts": {"Morton order of the queries": lambda: morton_order(q_shard, qm_shard)}},
    ]


def check_kernels(cases, reps: int = 5) -> dict:
    """Phase 2: kernel vs plain on identical inputs, the kernel run twice
    (identical bits: no atomics), times against the bound; per-kernel
    summary."""
    summary = {}
    for c in cases:
        name, case = c["name"], c["case"]
        got, want = c["kernel"](), c["plain"]()
        err = plane_rel_err(got, want)
        max_abs = float((got - want).abs().max())
        again = c["kernel"]()
        ms, call_ms = graph_ms(c["kernel"]), cuda_ms(c["kernel"], reps)
        plain_ms = cuda_ms(c["plain"], max(1, reps // 2))
        lib_ms = graph_ms(c["library"]) if c["library"] is not None else None
        parts = {part: graph_ms(fn) for part, fn in c.get("parts", {}).items()}
        bound, bound_by = c["bound"]
        print(f"kernel {name} [{case}]: max_abs_err {max_abs:.3e}, rel err {err:.3e} "
              f"(tol {REL_TOL:g}), kernel {ms:.4f} ms device ({call_ms:.4f} ms one call "
              f"with its enqueue), plain {plain_ms:.3f} ms, bound {bound:.4f} ms by {bound_by} "
              f"({100 * bound / ms:.1f}% of bound), library "
              + (f"{lib_ms:.4f} ms ({c['library_note']})" if lib_ms is not None
                 else f"null ({c['library_note']})")
              + "".join(f"; of the kernel's time, {part} {t:.4f} ms" for part, t in parts.items()))
        if not err <= REL_TOL:
            raise AssertionError(f"{name} [{case}] disagrees with its plain version: {err:.3e}")
        if name == "knn_moments" and not torch.equal(got[:, 0], want[:, 0]):
            raise AssertionError("knn_moments membership counts differ from the plain version")
        if not torch.equal(got, again):
            raise AssertionError(f"{name} [{case}] gave other bits on a second call")
        sm = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                       "bound_ms": 0.0, "library_ms": 0.0, "cases": []})
        sm["max_abs_err"] = max(sm["max_abs_err"], max_abs)
        sm["ms"] += ms
        sm["plain_ms"] += plain_ms
        sm["bound_ms"] += bound
        sm["library_ms"] = None if lib_ms is None or sm["library_ms"] is None else \
            sm["library_ms"] + lib_ms
        sm["bound_by"] = bound_by if sm.get("bound_by", bound_by) == bound_by else "mixed"
        sm["cases"].append({"case": case, "max_abs_err": max_abs, "rel_err": err, "ms": ms,
                            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": lib_ms,
                            "library": c["library_note"], "parts_ms": parts})
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


def _writable(state):
    """The state with fresh copies of the stores a loop step or a prior
    cycle writes in place (they only read the keyframe DB)."""
    def clone(nt):
        return type(nt)(*(t.clone() for t in nt))

    g = state.graph
    return state._replace(graph=g._replace(loops=clone(g.loops), priors=clone(g.priors)),
                          loop_matched=state.loop_matched.clone(),
                          prior_queue=clone(state.prior_queue))


def _trace(step, pre, sync):
    """bench.profile_run of `step` on three fresh copies of the pre-step
    state (the step writes its stores in place)."""
    copies = [_writable(pre) for _ in range(3)]

    def run():
        step(copies.pop())
        sync()

    return bench.profile_run(run)


def _stats(ms):
    return (f"median {statistics.median(ms):.2f} max {max(ms):.2f} over {len(ms)}"
            if ms else "none")


def mapping(cfg: RoloConfig, frames):
    """Phase 5: one lap of the SLAM loop, scan by scan in the order of
    runtime/slam.py:333-535: scan_step and the ESKF measurement on every
    scan; at the mapping cadence backend_step, the mapping odometry and the
    live ground-map update; the fused pose; loop_closure_step at 1 Hz; the
    prior cycle at 5 Hz once a mapping step has run; solve_graph_host when
    a loop or prior step ran since the last solve, at most every
    graph_solve_check_interval; one more solve at the end, as finalize does.
    The runtime's background scheduler (at most one task per scan) is not
    ported: the background steps run inline, in tick order. The frames start
    at scan 0, so "frame 0's coordinates" are the map's."""
    st, reg, lc = cfg.static, cfg.registration, cfg.loop
    dev = frames[0].points.device
    sync = torch.cuda.synchronize if frames[0].points.is_cuda else (lambda: None)
    feats = [bench.featurize_parts(f, cfg) for f in frames]
    front = init_state(st.max_feature_points, dev)
    state = init_backend(cfg, dev)
    fus = init_fusion(cfg.filter, dev)
    live = init_live_ground(st.live_ground_slots, st.live_ground_slot_points, dev)
    vehicle = vehicle_from_config(cfg.prior, dev)
    front_trans, fused_trans, steps, loops, priors, solves, traces = [], [], [], [], [], [], {}
    last_map = last_loop = last_prior = -float("inf")
    last_stamp, dirty, next_solve, ate_before = None, False, 0.0, None
    kf_scans = []

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    def solve(i, hint):
        nonlocal state, ate_before
        counts = (int(state.graph.loops.count), int(state.graph.priors.count))
        if ate_before is None and counts[0] >= 1:
            ate_before = _ate(state.db.trans[:len(kf_scans)], [frames[k] for k in kf_scans])
        state, ms = timed(lambda: solve_graph_host(state, cfg, count_hint=hint))
        solves.append((i, counts, ms))

    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t_run, t_traces = time.perf_counter(), 0.0
    for i, ((fc, img), frame) in enumerate(zip(feats, frames)):
        stamp = frame.stamp
        interval = cfg.sensor.scan_period if last_stamp is None else max(stamp - last_stamp, 1e-3)
        last_stamp = stamp
        feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)
        front, fo = scan_step(front, feat.xyz, feat.mask, interval, reg, st.max_voxels,
                              reg.k_correspondences, enable_failure_gate=reg.enable_failure_gate)
        front_trans.append(fo.pose_trans)
        fus, _ = on_front_odometry(fus, stamp, fo.pose_rot, fo.pose_trans, cfg.filter)
        if stamp - last_map >= cfg.mapping.mapping_process_interval:
            last_map = stamp
            raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
            sc_cloud = raw if lc.sc_input_type == "scan_raw" else fc.surfaces
            (state, out), ms = timed(lambda: backend_step(
                state, fc.corners, fc.surfaces, sc_cloud, fo.pose_rot, fo.pose_trans, True, stamp,
                cfg))
            steps.append((i, out, ms))
            if bool(out.keyframe_added):
                kf_scans.append(i)
            fus = on_mapping_odometry(fus, out.rot, out.trans, fo.pose_rot, fo.pose_trans)
            if cfg.prior.enable:
                live = ground_update(live, img, out.rot, out.trans, cfg)
        fused_trans.append(fused_pose(fus, stamp, cfg.filter).trans)

        if lc.enable and stamp - last_loop >= 1.0 / lc.frequency_hz:
            last_loop = stamp
            pre = _writable(state)
            det = detect_loop(state.scdb, lc)
            cur = torch.clamp(state.db.count - 1, min=0)
            sc_hit = bool(det.found & (det.index != cur) & (state.db.count > 0))
            rs_hit = bool(detect_loop_distance(state.db, state.loop_matched,
                                               lc.history_search_radius,
                                               lc.history_search_time_diff)[1])
            n_before = int(state.graph.loops.count)
            (state, closed), ms = timed(lambda: loop_closure_step(state, cfg))
            new = [(int(state.graph.loops.i[k]), int(state.graph.loops.j[k]),
                    float(state.graph.loops.noise_var[k, 0]),
                    "sc" if float(state.graph.loops.robust_c[k]) > 0 else "rs")
                   for k in range(n_before, int(state.graph.loops.count))]
            sc_accepted = any(kind == "sc" for *_, kind in new)
            loops.append((i, sc_hit, rs_hit and not sc_accepted, new, ms))
            if bool(closed) and "loop" not in traces and frame.points.is_cuda:
                t0 = time.perf_counter()
                traces["loop"] = _trace(lambda s: loop_closure_step(s, cfg), pre, sync)
                t_traces += time.perf_counter() - t0
            dirty = True
        if (cfg.prior.enable and len(steps) >= 1
                and stamp - last_prior >= 1.0 / cfg.prior.frequency_hz):
            last_prior = stamp
            gm = live.as_ground_map()
            pre = _writable(state)
            n_queue = int(state.prior_queue.count)
            (state, matched), ms = timed(lambda: prior_cycle(fus, stamp, state, gm, vehicle, cfg))
            priors.append((i, int(state.prior_queue.count) > n_queue, bool(matched), ms))
            if bool(matched) and "prior" not in traces and frame.points.is_cuda:
                t0 = time.perf_counter()
                traces["prior"] = _trace(
                    lambda s: prior_cycle(fus, stamp, s, gm, vehicle, cfg), pre, sync)
                t_traces += time.perf_counter() - t0
            dirty = True
        if dirty and len(steps) >= 1 and stamp >= next_solve:
            next_solve = stamp + cfg.mapping.graph_solve_check_interval
            dirty = False
            solve(i, len(steps) + 1)
    if dirty or bool(state.pending_solve):
        solve(len(frames) - 1, None)
    sync()
    seconds = time.perf_counter() - t_run - t_traces
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}

    n_kf = int(state.db.count)
    kf_frames = [frames[i] for i in kf_scans]
    front_ate = _ate(torch.stack([front_trans[i] for i in kf_scans]), kf_frames)
    map_ate = _ate(state.db.trans[:n_kf], kf_frames)
    nfac = [int(out.num_factors) for _, out, _ in steps]
    degen = [int(bool(out.degenerate)) for _, out, _ in steps]
    step_ms = [ms for _, _, ms in steps[2:]]  # after the first step and a warm optimizing one
    step_ms_60 = [ms for i, _, ms in steps[2:] if i < 60]
    g = state.graph
    loop_factors = [(int(g.loops.i[k]), int(g.loops.j[k]), float(g.loops.noise_var[k, 0]))
                    for k in range(int(g.loops.count))]
    print(f"mapping: {len(frames)} scans in {seconds:.2f} s (traces excluded), {len(steps)} "
          f"mapping steps, {n_kf} keyframes added (scans {kf_scans})")
    print(f"mapping: s2m_iterations {[int(out.s2m_iterations) for _, out, _ in steps]}")
    print(f"mapping: num_factors {nfac}")
    print(f"mapping: degenerate {degen}")
    print(f"mapping: backend_step wall ms {_stats(step_ms_60)} steps of the first 60 scans; "
          f"{_stats(step_ms)} steps of the lap")
    print(f"loop: {len(loops)} ticks at scans {[t[0] for t in loops]}; scan-context detections "
          f"{sum(t[1] for t in loops)}, radius-search detections {sum(t[2] for t in loops)}, "
          f"accepted {sum(len(t[3]) for t in loops)}: "
          f"{[(i, new) for i, _, _, new, _ in loops if new]}")
    print(f"loop: factors (i, j, fitness) {loop_factors}")
    print(f"loop: loop_closure_step wall ms {_stats([t[4] for t in loops])}")
    print(f"prior: {len(priors)} cycles, {sum(t[1] for t in priors)} observations pushed "
          f"(queue count {int(state.prior_queue.count)}), {int(g.priors.count)} prior factors "
          f"accepted at scans {[t[0] for t in priors if t[2]]}, factors (i, j) "
          f"{[(int(g.priors.i[k]), int(g.priors.j[k])) for k in range(int(g.priors.count))]}")
    print(f"prior: cycle wall ms {_stats([t[3] for t in priors])}; dropped_counts "
          f"{state.dropped_counts.tolist()} (keyframes, loops, priors, queue overwrites)")
    print(f"solve: {len(solves)} solves at scans {[t[0] for t in solves]} with (loops, priors) "
          f"{[t[1] for t in solves]}; wall ms {[round(t[2], 2) for t in solves]}")
    print(f"mapping: ATE over the {n_kf} keyframe scans: front-end {front_ate:.4f} m, mapped "
          f"keyframes {map_ate:.4f} m after the final solve"
          + (f", {ate_before:.4f} m over the keyframes before the first loop solve"
             if ate_before is not None else "") + f"; launches {launches}")
    for name, prof in traces.items():
        print(f"profile of one {'loop_closure_step' if name == 'loop' else 'prior cycle'}: "
              f"{json.dumps(prof)}")

    poses = torch.cat([state.db.rot[:n_kf].reshape(-1), state.db.trans[:n_kf].reshape(-1),
                       torch.stack(front_trans).reshape(-1), torch.stack(fused_trans).reshape(-1),
                       state.xyz, state.rpy])
    if not bool(torch.isfinite(poses).all()):
        raise AssertionError("non-finite mapping poses")
    if n_kf != len(kf_scans) or n_kf < MIN_KEYFRAMES:
        raise AssertionError(f"mapping added {n_kf} keyframes (need >= {MIN_KEYFRAMES})")
    starved = [(i, n) for (i, out, _), n in zip(steps[1:], nfac[1:]) if n < MIN_FACTORS]
    if starved:
        raise AssertionError(f"optimized steps with < {MIN_FACTORS} factors: {starved}")
    if not loop_factors:
        raise AssertionError("the lap closed no loop")
    near = [(i, j) for i, j, _ in loop_factors if abs(i - j) < lc.sc_num_exclude_recent]
    if near:
        raise AssertionError(f"loop factors closer than {lc.sc_num_exclude_recent} keyframes: "
                             f"{near}")
    if int(g.priors.count) < 1:
        raise AssertionError("the lap accepted no prior factor")
    if not any(n_loops >= 1 and n_priors >= 1 for _, (n_loops, n_priors), _ in solves):
        raise AssertionError("no graph solve ran with loop and prior factors in the graph")
    if not map_ate <= front_ate:
        raise AssertionError(f"mapped keyframe ATE {map_ate:.4f} m exceeds the front-end's "
                             f"{front_ate:.4f} m over the same scans")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the mapping path")
    if frames[0].points.is_cuda:
        # one more step of the last mapped scan, traced (it rewrites the DB
        # row past the count: the state above is not advanced)
        i = steps[-1][0]
        fc, img = feats[i]
        raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
        rot, trans = state.db.rot[n_kf - 1], state.db.trans[n_kf - 1]

        def run():
            backend_step(state, fc.corners, fc.surfaces, raw, rot, trans, True, frames[i].stamp,
                         cfg)
            sync()

        print(f"profile of one backend_step: {json.dumps(bench.profile_run(run))}")
        kabsch_timing(dev)
    return launches, front_ate, map_ate


def kabsch_timing(device, reps: int = 20):
    """The loop ICP's Kabsch step on the card (an SVD whose info check syncs)
    beside the same iteration's exact 1-NN search at the loop path's 4,096 x
    16,384 points."""
    g = torch.Generator(device="cpu").manual_seed(0)
    h = torch.randn(3, 3, generator=g).to(device)
    src = (torch.rand(4096, 3, generator=g) * 60 - 30).to(device)
    tgt = (torch.rand(16384, 3, generator=g) * 60 - 30).to(device)
    ones = torch.ones(16384, dtype=torch.bool, device=device)
    print(f"kabsch: {cuda_ms(lambda: kabsch_rotation(h), reps):.3f} ms per call; 1-NN 4096 x "
          f"16384 {cuda_ms(lambda: knn_indices(src, ones[:4096], tgt, ones, 1), reps):.3f} ms")


def _percentiles(ms) -> str:
    if not ms:
        return "none"
    a = np.asarray(ms)
    return (f"p50 {np.percentile(a, 50):.2f} p95 {np.percentile(a, 95):.2f} max {a.max():.2f} ms "
            f"over {a.size}")


def _pose_diff(got: dict, want: dict) -> float:
    keys = [k for k in want if k.endswith(("_rot", "_trans"))]
    if sorted(got) != sorted(want):
        raise AssertionError(f"restored system published {sorted(got)}, the original {sorted(want)}")
    return max(float((got[k] - want[k]).abs().max()) for k in keys)


def runtime_lap(cfg: RoloConfig, frames, device=None):
    """Phase 6: SlamSystem through run_frames, as a user runs it, with the
    runtime's own scheduler and deskew. Returns the system and each
    kernel's launches over the lap. `device` None is the card, as for a
    user; "cpu" rehearses the phase."""
    slam = SlamSystem(cfg, device)
    sync = torch.cuda.synchronize if slam.device.type == "cuda" else (lambda: None)
    scans, dispatched, solves = [], [], []
    real_process, real_dispatch = slam.process_scan, slam._dispatch_background
    real_solve = backend_module.solve_graph_host

    def process(points, stamp, ring=None, rel_time=None):
        t0 = time.perf_counter()
        out = real_process(points, stamp, ring=ring, rel_time=rel_time)
        slam.published()  # the scan's poses on the host, as a real-time consumer reads them
        scans.append(((time.perf_counter() - t0) * 1e3, "mapped_trans" in out))
        return out

    def dispatch(task, stamp, out, prof):
        dispatched.append((len(slam.times), task))
        return real_dispatch(task, stamp, out, prof)

    def solve(state, *args, **kwargs):  # the factor counts each solve carries, not fetched yet
        solves.append(torch.stack([state.graph.loops.count, state.graph.priors.count]).clone())
        return real_solve(state, *args, **kwargs)

    slam.process_scan, slam._dispatch_background = process, dispatch
    backend_module.solve_graph_host = solve
    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    try:
        t0 = time.perf_counter()
        res = run_frames(slam, frames)
        sync()
        seconds = time.perf_counter() - t0
    finally:
        backend_module.solve_graph_host = real_solve
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    del slam.process_scan, slam._dispatch_background

    n = len(frames)
    times = np.asarray(slam.times)
    kt, kp, _ = slam.keyframe_trajectory()
    kf_scans = np.abs(times[None, :] - kt[:, None]).argmin(axis=1).tolist()
    kf_frames = [frames[i] for i in kf_scans]
    front = slam.front_positions_np()
    front_ate = _ate(torch.as_tensor(front[kf_scans]), kf_frames)
    map_ate = _ate(torch.as_tensor(kp), kf_frames)
    _, fused, _ = slam.fused_trajectory_np()
    solve_counts = [tuple(c.tolist()) for c in solves]
    queued = collections.Counter(i for i, task in dispatched if task != "prior" and i < n)
    per_scan = collections.Counter(queued[i] for i in range(n))
    mapped_ms = [ms for ms, mapped in scans if mapped]
    other_ms = [ms for ms, mapped in scans if not mapped]
    synced_rate = 1e3 * n / sum(ms for ms, _ in scans)
    print(f"runtime: {n} scans in {seconds:.2f} s ({synced_rate:.3f} scans/s synced at each "
          f"fused-pose fetch; run_frames {res.scans_per_s:.3f}), {res.n_keyframes} keyframes, "
          f"{res.n_loop_factors} loop / {res.n_prior_factors} prior factors; launches {launches}")
    print(f"runtime: process_scan wall, mapping scans {_percentiles(mapped_ms)}; other scans "
          f"{_percentiles(other_ms)}")
    print("runtime: stages " + "; ".join(
        f"{k} n={v['count']} p50 {v['p50_ms']:.2f} p95 {v['p95_ms']:.2f} max {v['max_ms']:.2f} ms"
        for k, v in slam.timers.summary().items()))
    print(f"runtime: queued tasks dispatched per scan {dict(sorted(per_scan.items()))}; "
          f"dispatches (scan, task) {[d for d in dispatched if d[1] != 'prior']}; "
          f"{sum(t == 'prior' for _, t in dispatched)} prior cycles; solves with "
          f"(loops, priors) {solve_counts}; dropped {res.drop_counts}")
    print(f"runtime: ATE over the {len(kf_scans)} keyframe scans (deskew on): front-end "
          f"{front_ate:.4f} m, mapped keyframes {map_ate:.4f} m after finalize; aligned "
          f"(run_frames) front-end {res.ate_frontend.rmse:.4f} m, keyframes "
          f"{res.ate_keyframes.rmse:.4f} m")

    if not (np.isfinite(front).all() and np.isfinite(kp).all() and np.isfinite(fused).all()):
        raise AssertionError("non-finite runtime poses")
    if res.n_keyframes < MIN_KEYFRAMES:
        raise AssertionError(f"the runtime lap added {res.n_keyframes} keyframes")
    if res.n_loop_factors < 1 or res.n_prior_factors < 1:
        raise AssertionError("the runtime lap accepted no loop factor or no prior factor")
    if not any(a >= 1 and b >= 1 for a, b in solve_counts):
        raise AssertionError("no runtime solve ran with loop and prior factors in the graph")
    if not map_ate <= front_ate:
        raise AssertionError(f"runtime mapped keyframe ATE {map_ate:.4f} m exceeds the "
                             f"front-end's {front_ate:.4f} m")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by SlamSystem")
    if max(per_scan) > 1:
        raise AssertionError(f"a scan dispatched more than one queued task: {per_scan}")
    return slam, launches


def restore_check(slam: SlamSystem, next_frame) -> None:
    """Phase 6, last: checkpoint `slam`, restore fresh systems from it, and
    run the next scan on each. Under torch's default algorithms the original
    and a restored system, and two restored systems, must give the same
    bits (the port sums in a fixed order, no float atomics); under
    deterministic algorithms two more restored systems must too. Three more
    restored systems give one traced process_scan (bench.profile_run:
    kernels, launches, the host's waits for the card)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slam.npz")
        t0 = time.perf_counter()
        slam.checkpoint(path)
        twins = [SlamSystem(slam.cfg, slam.device) for _ in range(8)]
        for twin in twins:
            twin.restore(path)
        ckpt_s, size = time.perf_counter() - t0, os.path.getsize(path)
    sync = torch.cuda.synchronize if slam.device.type == "cuda" else (lambda: None)

    def step(system):
        sync()
        t0 = time.perf_counter()
        out = system.process_scan(next_frame.points, next_frame.stamp, ring=next_frame.ring,
                                  rel_time=next_frame.rel_time)
        sync()
        return out, (time.perf_counter() - t0) * 1e3

    (want, ms), (got, _) = step(slam), step(twins[0])
    (a, _), (b, _) = step(twins[1]), step(twins[2])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (c, det_ms), (d, _) = step(twins[3]), step(twins[4])
    finally:
        torch.use_deterministic_algorithms(False)
    diff, spread, det_spread = _pose_diff(got, want), _pose_diff(a, b), _pose_diff(c, d)
    traced = twins[5:]
    prof = bench.profile_run(lambda: step(traced.pop()))  # host_waits: 2 are step()'s own
    print(f"profile of one process_scan (the next scan, restored): {json.dumps(prof)}")
    print(f"runtime: checkpoint + 8 restores {ckpt_s:.2f} s ({size / 1e6:.1f} MB); the next "
          f"scan ({sorted(want)}) by default: original vs restored, max pose difference "
          f"{diff:.3e}; two restored systems {spread:.3e} ({ms:.1f} ms a scan); under "
          f"deterministic algorithms two restored systems {det_spread:.3e} ({det_ms:.1f} ms a "
          f"scan)")
    for name, x, y in (("the original and its restored twin", want, got),
                       ("two restored twins", a, b),
                       ("two restored twins under deterministic algorithms", c, d)):
        if not all(torch.equal(x[k], y[k]) for k in y):
            raise AssertionError(f"{name} differ in the next scan by {_pose_diff(x, y):.3e}")


def cli_on_recorded_data(timeout: int = 600, device=None):
    """Phase 7: `python -m rolo_tpu_torch run` on the bag fixture, on the
    card (`device` None: the CLI's default), in a subprocess killed at the
    timeout."""
    fixture = os.path.join(ROOT, "tests", "fixtures", "sim_bag")
    with tempfile.TemporaryDirectory() as out:
        cmd = [sys.executable, "-m", "rolo_tpu_torch", "run",
               "--input", os.path.join(fixture, "seq.bag"),
               "--config", os.path.join(fixture, "config.yaml"),
               "--gt", os.path.join(fixture, "gt_tum.txt"), "--output", out]
        cmd += ["--device", device] if device else []
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout[proc.stdout.index("{"):])
        missing = [f for f in ("front_end_tum.txt", "optimized_tum.txt", "pose_graph.g2o",
                               "global_map.pcd") if not os.path.exists(os.path.join(out, f))]
    print(f"cli: run on the bag fixture in {seconds:.1f} s (process included): {res['n_scans']} "
          f"scans, front-end ATE {res.get('ate_frontend_rmse_m')} m, keyframe ATE "
          f"{res.get('ate_keyframes_rmse_m')} m, {res['n_keyframes']} keyframes")
    if res["n_scans"] != 12 or not res.get("ate_frontend_rmse_m", np.inf) < 0.5:
        raise AssertionError(f"the CLI's result is outside its bounds: {res}")
    if missing:
        raise AssertionError(f"the CLI wrote no {missing}")


SPMD_ROT, SPMD_TRANS = 2e-4, 2e-3  # tests/test_parallel.py:239-244


def _equal_fields(got, want) -> bool:
    """Every leaf of two trees of tensors (tuples or lists at the top) bit-equal."""
    got, want = tree_leaves(tuple(got)), tree_leaves(tuple(want))
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def _pose_ekf():
    """tests/test_manifold.py's pose filter: (pos, SO3 rot, vel, omega, acc,
    alpha) with a constant-jerk process and a pose measurement."""
    decl = [("pos", manifold.Vect(3)), ("rot", manifold.SO3()), ("vel", manifold.Vect(3)),
            ("omega", manifold.Vect(3)), ("acc", manifold.Vect(3)), ("alpha", manifold.Vect(3))]

    def process(x, dt):
        rot_vec = dt * (x["omega"] + 0.5 * dt * x["alpha"])
        return {"pos": x["pos"] + dt * (x["vel"] + 0.5 * dt * x["acc"]),
                "rot": x["rot"] @ so3.exp(rot_vec), "vel": x["vel"] + dt * x["acc"],
                "omega": x["omega"] + dt * x["alpha"], "acc": x["acc"], "alpha": x["alpha"]}

    return manifold.GenericEKF(decl=decl, process=process,
                               measure=lambda x: {"pos": x["pos"], "rot": x["rot"]},
                               meas_decl=[("pos", manifold.Vect(3)), ("rot", manifold.SO3())])


def generic_ekf_step(device):
    """One GenericEKF predict + update_iterated from a seeded state: (state
    dict, covariance) on the CPU."""
    g = torch.Generator(device="cpu").manual_seed(3)
    x = {k: (torch.randn(3, generator=g) * 0.5) for k in ("pos", "vel", "omega", "acc", "alpha")}
    x["rot"] = so3.exp(torch.randn(3, generator=g) * 0.4)
    p = torch.diag(torch.rand(18, generator=g) * 0.1 + 0.01)
    q = torch.diag(torch.cat([torch.zeros(12), torch.full((6,), 1e-4)]))
    z = {"pos": x["pos"] + torch.randn(3, generator=g) * 0.3,
         "rot": x["rot"] @ so3.exp(torch.randn(3, generator=g) * 0.1)}
    r = torch.diag(torch.tensor([0.01] * 3 + [0.001] * 3))
    on = {k: v.to(device) for k, v in x.items()}
    ekf = _pose_ekf()
    on, pc = manifold.predict(ekf, on, p.to(device), q.to(device), 0.1)
    on, pc = manifold.update_iterated(ekf, on, pc, {k: v.to(device) for k, v in z.items()},
                                      r.to(device), iterations=4)
    return {k: v.cpu() for k, v in on.items()}, pc.cpu()


def parallel_slice(cfg: RoloConfig, pairs, clouds, frames, ground, device):
    """Phase 8: this slice's paths at RoloConfig() width on a one-rank
    process group (NCCL on the card), each step timed, with the kernels'
    launches counted over the whole phase. `pairs` are phase 3's bench
    pairs, `clouds` / `frames` phase 4's scans, `ground` (map, keyframe
    positions, keyframe yaws) the runtime lap's live ground map."""
    reg, st = cfg.registration, cfg.static
    cap, k = st.max_voxels, reg.k_correspondences
    src, sm, tgt, tm, gt_rot, gt_trans = pairs
    sync = torch.cuda.synchronize if src.is_cuda else (lambda: None)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t0
        return out

    def gate(name, rot, trans, g_rot, g_trans):
        rot_err, trans_err = bench.pose_errors(rot, trans, g_rot, g_trans)
        ok = (float(rot_err.max()) < bench.GATE_ROT_DEG
              and float(trans_err.max()) < bench.GATE_TRANS_M)
        return ok, f"{name}: {float(rot_err.max()):.4f} deg / {float(trans_err.max()):.5f} m"

    if device.type == "cuda":
        distributed_init(f"localhost:{launch.free_port()}", 1, 0, backend="nccl")
    mesh = make_mesh(device_type=device.type)
    point_mesh = make_mesh(axis_names=("point",), device_type=device.type)
    print(f"parallel: one-rank group, backend {torch.distributed.get_backend()}")
    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t_phase = time.perf_counter()

    # (a) registration_batch on the bench pairs: the rank's slice is all 16
    want = bench.register_batch(src, sm, tgt, tm, torch.zeros_like(gt_trans), reg, cap, k)
    got = timed("a registration_batch", lambda: registration_batch(
        *shard_registration_inputs(mesh, src, sm, tgt, tm, interval=0.2), cfg=reg,
        voxel_capacity=cap, k=k))
    if not _equal_fields(got, want):
        raise AssertionError("registration_batch differs from register_scan_pair")
    print(f"parallel (a): registration_batch of {src.shape[0]} pairs bit-equal to "
          f"register_scan_pair")

    # (b) the batch's median pair (by (a)'s translation error, the lower of
    # the middle two) with its points split over the group
    _, trans_err = bench.pose_errors(want.rot, want.trans, gt_rot, gt_trans)
    i = int(np.argsort(trans_err)[(len(trans_err) - 1) // 2])
    zero = torch.zeros(3, device=device)
    dt = torch.tensor(0.2, device=device)
    one = register_scan_pair(src[i:i + 1], sm[i:i + 1], tgt[i:i + 1], tm[i:i + 1], zero[None],
                             zero[None], dt[None], dt[None], reg, cap, k)
    sp = timed("b register_scan_pair_spmd", lambda: register_scan_pair_spmd(
        point_mesh, src[i], sm[i], tgt[i], tm[i], zero, zero, dt, dt, reg, cap, k))
    d_rot = float((sp.rot - one.rot[0]).abs().max())
    d_trans = float((sp.trans - one.trans[0]).abs().max())
    ok, msg = gate(f"spmd on pair {i} against ground truth", sp.rot[None], sp.trans[None],
                   gt_rot[i:i + 1], gt_trans[i:i + 1])
    print(f"parallel (b): register_scan_pair_spmd vs register_scan_pair max |diff| rot "
          f"{d_rot:.3e}, trans {d_trans:.3e} m (limits {SPMD_ROT:g} / {SPMD_TRANS:g}); {msg}")
    if not (d_rot <= SPMD_ROT and d_trans <= SPMD_TRANS and ok):
        raise AssertionError("register_scan_pair_spmd outside its limits")

    # (c), (d) SE(3) and multi-point GICP on the consecutive pair (0, 1)
    # from the identity; one that fails the gate there runs again on the
    # pair (1, 2) from the constant-velocity guess, the motion of (0, 1)
    def consecutive(i):
        g_rot, g_trans = bench.gt_relative(frames[i].gt_rot, frames[i].gt_trans,
                                           frames[i + 1].gt_rot, frames[i + 1].gt_trans)
        return (clouds[i].xyz[None], clouds[i].mask[None], clouds[i + 1].xyz[None],
                clouds[i + 1].mask[None]), (g_rot[None], g_trans[None])

    solvers = {
        "c register_se3": lambda c, r0, t0: register_se3(*c, r0, t0, reg, cap, k),
        "d register_multipoint": lambda c, r0, t0: register_multipoint(
            make_problem(*c, k_cov=k), r0, t0, k=8),
    }
    starts = [(0, torch.eye(3, device=device)[None], torch.zeros(1, 3, device=device),
               "the identity"), (1, *consecutive(0)[1], "the constant-velocity guess")]
    for name, solve in solvers.items():
        for i, r0, t0, start in starts:
            cloud, (g_rot, g_trans) = consecutive(i)
            res = timed(f"{name} from {start}", lambda: solve(cloud, r0, t0))
            ok, msg = gate(f"{name[2:]} on scans ({i}, {i + 1}) from {start}", res.rot,
                           res.trans, g_rot, g_trans)
            print(f"parallel ({name[0]}): {msg}, converged {bool(res.converged[0])}, "
                  f"{int(res.iterations[0])} iterations")
            if ok:
                break
        else:
            raise AssertionError(f"{name[2:]} outside the bench gate")

    # (e) odometry_batch: phase 4's scans forward and backward, two sequences
    xyz = torch.stack([c.xyz for c in clouds])
    mask = torch.stack([c.mask for c in clouds])
    seqs = (torch.stack([xyz, xyz.flip(0)]), torch.stack([mask, mask.flip(0)]))
    intervals = torch.full(seqs[1].shape[:2], 0.1, device=device)
    outs = timed("e odometry_batch", lambda: odometry_batch(*seqs, intervals, reg, cap, k))
    singles = timed("e run_sequence x2", lambda: [run_sequence(seqs[0][i], seqs[1][i],
                                                              intervals[i], reg, cap, k)
                                                  for i in range(2)])
    for i, single in enumerate(singles):
        if not _equal_fields(single, [f[i] for f in outs]):
            raise AssertionError(f"odometry_batch sequence {i} differs from its run_sequence")
    print(f"parallel (e): odometry_batch over 2 sequences of {xyz.shape[0]} scans bit-equal to "
          f"each run_sequence")

    # (f) prior_solve_batch at B=16 on the lap's ground map
    gm, kf_xy, kf_yaw = ground
    pick = torch.linspace(0, kf_xy.shape[0] - 1, 16).round().long()
    qx, qy, qyaw = (t.to(device) for t in (kf_xy[pick, 0], kf_xy[pick, 1], kf_yaw[pick]))
    vehicle = vehicle_from_config(cfg.prior, device)
    batch = timed("f prior_solve_batch", lambda: prior_solve_batch(gm, vehicle, qx, qy, qyaw,
                                                                   cfg.prior))
    scalars = timed("f solve_pose x16", lambda: [solve_pose(gm, vehicle, qx[i], qy[i], qyaw[i],
                                                            cfg.prior) for i in range(16)])
    for i, one_res in enumerate(scalars):
        if not _equal_fields(one_res, [f[i] for f in batch]):
            raise AssertionError(f"prior_solve_batch instance {i} differs from solve_pose")
    print(f"parallel (f): prior_solve_batch of 16 keyframe poses bit-equal to solve_pose; "
          f"{int(batch.converged.sum())} converged, {int(batch.success.sum())} succeeded")

    # (g) the dry run on this group
    timed("g dryrun_multichip(1)", lambda: dryrun_multichip(1, device))

    # (h) the generic manifold EKF on the card against the CPU
    got_x, got_p = timed("h GenericEKF", lambda: generic_ekf_step(device))
    want_x, want_p = generic_ekf_step("cpu")
    ekf_err = max([float((got_x[name] - want_x[name]).abs().max()) for name in want_x]
                  + [float((got_p - want_p).abs().max() / max(1.0, float(want_p.abs().max())))])
    print(f"parallel (h): GenericEKF predict + update_iterated, card vs CPU max err "
          f"{ekf_err:.3e} (tol 1e-5)")
    if not ekf_err <= 1e-5:
        raise AssertionError("GenericEKF on the card disagrees with the CPU")

    sync()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    print(f"parallel: phase 8 steps wall s {json.dumps({n: round(t, 3) for n, t in times.items()})}"
          f", {time.perf_counter() - t_phase:.1f} s in all; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 8")
    torch.distributed.destroy_process_group()
    return launches


N_BATCH_SEQ, SEQ_LEN = 16, 15  # phase 9: phase 5's frames as 16 sequences of 15 scans
MIN_SEQ_KEYFRAMES = 5
KF_GATE_M = 0.25  # tools/bench_batch_mapping.py:150
SOLVE_MOVE_M, DENSE_BCR_M = 0.05, 1e-4  # __graft_entry__.py:249-250
SOLVE_BUCKETS = (256, 512, 1024, 2048)
# phase 9's batched solves: "dense" first, the reference the others are held to
SOLVE_METHODS = ("dense", "bcr", "pcg chain", "pcg jacobi")


def _stack_clouds(clouds):
    return PaddedCloud(torch.stack([c.xyz for c in clouds]), torch.stack([c.mask for c in clouds]))


def batch_mapping(cfg: RoloConfig, frames, device):
    """Phase 9: offline batched mapping, `backend_step` over B sequences at
    once at RoloConfig() capacities. `frames` are phase 5's scans, cut into
    N_BATCH_SEQ sequences of SEQ_LEN consecutive scans; the front-end runs
    for all of them through odometry_batch, backend_step at the 0.15 s
    cadence as one batched call a step, then one batched solve_pose_graph
    with each of SOLVE_METHODS ("dense", "bcr", "pcg" with the chain and
    the Jacobi preconditioner) over the first 64 keyframe slots (the host
    solve's bucket), and one batched solve_graph_host. Gates, each
    raising: (a) every step's states and outputs, and each solve, bit-equal
    to the same sequences stepped and solved one at a time; (b) at least
    MIN_SEQ_KEYFRAMES keyframes a sequence; (c) the mapped keyframes within
    KF_GATE_M of the truth in each sequence's first-scan frame; (d) no
    keyframe moved more than SOLVE_MOVE_M by the solve, every other method
    within DENSE_BCR_M of "dense"; (e) both kernels launched (by the front-end). Then
    solve_graph_host's ms at each of SOLVE_BUCKETS on one sequence's
    state. Returns the kernels' launches over the phase."""
    st, reg, lc = cfg.static, cfg.registration, cfg.loop
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    seqs = [frames[i * SEQ_LEN:(i + 1) * SEQ_LEN] for i in range(N_BATCH_SEQ)]
    parts = [[bench.featurize_parts(f, cfg) for f in seq] for seq in seqs]
    feats = [[concat_clouds(fc.corners, fc.surfaces, st.max_feature_points) for fc, _ in seq]
             for seq in parts]
    xyz = torch.stack([torch.stack([c.xyz for c in seq]) for seq in feats])
    mask = torch.stack([torch.stack([c.mask for c in seq]) for seq in feats])
    stamps = np.array([[f.stamp for f in seq] for seq in seqs])
    intervals = np.concatenate([np.full((N_BATCH_SEQ, 1), cfg.sensor.scan_period),
                                np.maximum(np.diff(stamps, axis=1), 1e-3)], axis=1)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t_phase = time.perf_counter()
    front = timed("odometry_batch", lambda: odometry_batch(
        xyz, mask, torch.tensor(intervals, dtype=torch.float32, device=device), reg,
        st.max_voxels, reg.k_correspondences))
    batch = init_backend(cfg, device, batch=N_BATCH_SEQ)
    singles = [init_backend(cfg, device) for _ in range(N_BATCH_SEQ)]
    kf_scans = [[] for _ in range(N_BATCH_SEQ)]
    last, n_steps = -float("inf"), 0
    for i in range(SEQ_LEN):  # the cadence of sequence 0 (every sequence steps with it)
        if stamps[0, i] - last < cfg.mapping.mapping_process_interval:
            continue
        last, n_steps = stamps[0, i], n_steps + 1
        corner = _stack_clouds([p[i][0].corners for p in parts])
        surf = _stack_clouds([p[i][0].surfaces for p in parts])
        raw = [PaddedCloud(p[i][1].xyz.reshape(-1, 3), p[i][1].mask.reshape(-1)) for p in parts]
        sc_cloud = _stack_clouds(raw) if lc.sc_input_type == "scan_raw" else surf
        stamp = torch.tensor(stamps[:, i], dtype=torch.float32, device=device)
        last_inputs = (corner, surf, sc_cloud, front.pose_rot[:, i], front.pose_trans[:, i],
                       True, stamp)
        batch, out = timed("backend_step batched", lambda: backend_step(batch, *last_inputs, cfg))
        for b in range(N_BATCH_SEQ):
            def one():
                return backend_step(singles[b], PaddedCloud(corner.xyz[b], corner.mask[b]),
                                    PaddedCloud(surf.xyz[b], surf.mask[b]),
                                    PaddedCloud(sc_cloud.xyz[b], sc_cloud.mask[b]),
                                    front.pose_rot[b, i], front.pose_trans[b, i], True,
                                    stamp[b], cfg)
            singles[b], single_out = timed("backend_step looped", one)
            if not (_equal_fields(tree_index(out, b), single_out)
                    and _equal_fields(tree_index(batch, b), singles[b])):
                raise AssertionError(f"batched backend_step at scan {i}: sequence {b} differs "
                                     "from its step alone")
            if bool(out.keyframe_added[b]):
                kf_scans[b].append(i)
    print(f"batch mapping (a): {n_steps} batched backend_step calls over {N_BATCH_SEQ} "
          f"sequences bit-equal to each sequence stepped alone (states and outputs)")
    if device.type == "cuda":
        # the last step once more, traced (it writes the stores' rows past the
        # counts: the batch above is not advanced)
        def run():
            backend_step(batch, *last_inputs, cfg)
            sync()

        print(f"profile of one batched backend_step: {json.dumps(bench.profile_run(run))}")

    counts = batch.db.count.tolist()
    if min(counts) < MIN_SEQ_KEYFRAMES:
        raise AssertionError(f"batch mapping (b): keyframes per sequence {counts}")
    kf_err = []
    for b, seq in enumerate(seqs):
        g_rot = torch.stack([f.gt_rot for f in seq]).cpu().double()
        g_trans = torch.stack([f.gt_trans for f in seq]).cpu().double()
        truth = (g_rot[0].T @ (g_trans - g_trans[0]).T).T[kf_scans[b]]
        mapped = batch.db.trans[b, :counts[b]].cpu().double()
        kf_err.append(float((mapped - truth).norm(dim=-1).max()))
    print(f"batch mapping (b), (c): keyframes per sequence {counts}; max keyframe error per "
          f"sequence (m) {[round(e, 4) for e in kf_err]} (gate {KF_GATE_M})")
    if max(kf_err) >= KF_GATE_M:
        raise AssertionError(f"batch mapping (c): a keyframe {max(kf_err):.4f} m from the truth")

    bucket = 64
    sols, looped_sols = {}, {}
    for method in SOLVE_METHODS:
        def solve(state):
            g = state.graph
            g = g._replace(odom_rel_rot=g.odom_rel_rot[..., :bucket, :, :],
                           odom_rel_trans=g.odom_rel_trans[..., :bucket, :])
            name, _, pre = method.partition(" ")
            return solve_pose_graph(g, state.db.rot[..., :bucket, :, :],
                                    state.db.trans[..., :bucket, :], state.db.count,
                                    method=name, preconditioner=pre or "chain")
        sols[method] = timed(f"{method} solve batched", lambda: solve(batch))
        looped_sols[method] = timed(f"{method} solve looped",
                                    lambda: [solve(s) for s in singles])
        for b, one in enumerate(looped_sols[method]):
            if not _equal_fields(tree_index(sols[method], b), one):
                raise AssertionError(f"batched {method} solve: sequence {b} differs from its "
                                     "solve alone")
    moved = max(float((sols[m].trans[b, :counts[b]] - batch.db.trans[b, :counts[b]]).norm(
        dim=-1).max()) for m in sols for b in range(N_BATCH_SEQ))
    apart = max(float((sols["dense"].trans[b, :counts[b]] - sols[m].trans[b, :counts[b]]
                       ).abs().max()) for m in SOLVE_METHODS[1:] for b in range(N_BATCH_SEQ))
    batch = timed("solve_graph_host batched", lambda: solve_graph_host(batch, cfg))
    singles = timed("solve_graph_host looped",
                    lambda: [solve_graph_host(s, cfg) for s in singles])
    for b, one in enumerate(singles):
        if not _equal_fields(tree_index(batch, b), one):
            raise AssertionError(f"batched solve_graph_host: sequence {b} differs from its "
                                 "solve alone")
    print(f"batch mapping (a), (d): {', '.join(SOLVE_METHODS)} and solve_graph_host over "
          f"{N_BATCH_SEQ} graphs bit-equal to single solves; the solves moved a keyframe at "
          f"most {moved:.3e} m (gate {SOLVE_MOVE_M}), the others at most {apart:.3e} m from "
          f"dense (gate {DENSE_BCR_M})")
    if not (moved < SOLVE_MOVE_M and apart < DENSE_BCR_M):
        raise AssertionError("batch mapping (d): the solves moved keyframes or disagree")
    sync()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"batch mapping (e): kernel {name} was not launched in phase 9")

    mapped = N_BATCH_SEQ * n_steps
    print(f"batch mapping: mapped scans/s batched {mapped / times['backend_step batched']:.3f}, "
          f"looped {mapped / times['backend_step looped']:.3f}; graph solves/s batched dense "
          f"{N_BATCH_SEQ / times['dense solve batched']:.3f}, looped "
          f"{N_BATCH_SEQ / times['dense solve looped']:.3f}; "
          + "; ".join(f"{m} {N_BATCH_SEQ / times[f'{m} solve batched']:.3f} / "
                      f"{N_BATCH_SEQ / times[f'{m} solve looped']:.3f}"
                      for m in SOLVE_METHODS[1:])
          + "; solve_graph_host "
          f"{N_BATCH_SEQ / times['solve_graph_host batched']:.3f} / "
          f"{N_BATCH_SEQ / times['solve_graph_host looped']:.3f}; launches {launches}")
    print(f"batch mapping: phase 9 steps wall s {json.dumps({n: round(t, 3) for n, t in times.items()})}"
          f", {time.perf_counter() - t_phase:.1f} s in all")

    one = singles[0]
    bucket_ms = {}
    for hint in SOLVE_BUCKETS:
        if hint > one.db.capacity:
            continue
        solve_graph_host(one, cfg, count_hint=hint)  # warm
        ms = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            solve_graph_host(one, cfg, count_hint=hint)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        bucket_ms[hint] = round(statistics.median(ms), 2)
    print(f"batch mapping: solve_graph_host synced ms by bucket (count {int(one.db.count)}, "
          f"median of 3) {json.dumps(bucket_ms)}")
    return launches


def _tool(name: str):
    """tools/<name>.py as a module (the tools are scripts, not a package)."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


N_LATENCY = 40  # phase 10: the latency tool's first 20 scans run unpaced, 20 are measured
N_PIPE_WARMUP, N_PIPE = 10, 20
LATENCY_ATE_M = 1.0


def latency_and_pipeline(device):
    """Phase 10: the measuring tools on the card. The latency tool's
    `measure` over its own sim at N_LATENCY scans, without its warm pass
    (the earlier phases have warmed the process) and without bucket timings
    (phase 6 has them): the saturated feed, then the 10 Hz feed, each on a
    fresh SlamSystem(RoloConfig()). Raises unless each mode measured
    N_LATENCY - WARMUP finite latencies, no 10 Hz scan started before its
    arrival, each pass's ATE is finite and below LATENCY_ATE_M, and both
    kernels launched. Then the pipeline tool at --warmup N_PIPE_WARMUP
    --scans N_PIPE. Prints both reports as JSON lines; returns the kernels'
    launches over the latency passes."""
    latency, pipeline = _tool("torch_bench_latency"), _tool("torch_bench_pipeline")
    sim = latency.sim_config(N_LATENCY)
    frames = list(generate_sequence(sim, device))
    torch.cuda.synchronize()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t0 = time.perf_counter()
    report, sat, rt = latency.measure(frames, RoloConfig(), device, warm=False, buckets=(),
                                      n_cols=sim.n_cols)
    torch.cuda.synchronize()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    print(f"latency: two feed modes over {N_LATENCY} scans in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}")
    print(json.dumps(report))
    want = N_LATENCY - latency.WARMUP
    for mode, d in (("saturated", sat), ("10 Hz", rt)):
        if len(d.lat_all) != want or not np.isfinite(d.lat_all).all():
            raise AssertionError(f"latency ({mode}): {len(d.lat_all)} measured scans, want "
                                 f"{want} finite latencies")
        if not (np.isfinite(d.ate_rmse) and d.ate_rmse < LATENCY_ATE_M):
            raise AssertionError(f"latency ({mode}): ATE {d.ate_rmse} m (gate {LATENCY_ATE_M})")
    if rt.early_starts:
        raise AssertionError(f"latency: {rt.early_starts} 10 Hz scans started before arrival")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched in phase 10")
    psim = pipeline.sim_config(N_PIPE_WARMUP + N_PIPE)
    t0 = time.perf_counter()
    out = pipeline.run(list(generate_sequence(psim, device)), pipeline.config(), N_PIPE_WARMUP,
                       device=device)
    print(f"pipeline: {N_PIPE_WARMUP} + {N_PIPE} scans in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out))
    return launches


PROFILE_ITERS = 3  # phase 11: timed calls of each profiler row (and one traced)
DIAG_BUCKETS = (256, 2048)
# graphsolve's pcg only here: one pcg solve of its big graph takes ~51 s at 2,048
PCG_BUCKETS = (256,)
N_CT_PAIRS, N_PRIOR_SCANS = 4, 20
# phase 11: the solve diagnostics' methods against dense, where dense is
# finite (the f32 dense solve of diag_dense_solve's 1.4 km chain diverges at
# K = 2,048, in the JAX package from K = 1,024 with bcr as well)
SOLVE_AGREE_M = 1e-3


def _finite_rows(tool: str, rows: dict, keys) -> None:
    bad = {name: {k: row.get(k) for k in keys} for name, row in rows.items()
           if not all(k in row and np.isfinite(row[k]) for k in keys)}
    if bad:
        raise AssertionError(f"{tool}: rows without finite {keys}: {bad}")


def profiles_and_diagnostics(device):
    """Phase 11: the stage profilers at RoloConfig() widths with
    PROFILE_ITERS calls a row (the front-end's at 8,192 feature slots with
    5,500 valid and 8,192 voxels; the registration stages at B = 16; the
    build and lookup rows; the back-end's 80 keyframes; the projection),
    the solve diagnostics at DIAG_BUCKETS (one timed solve a method; pcg at
    PCG_BUCKETS only), the
    CT variants on N_CT_PAIRS bench pairs and the prior chain over
    N_PRIOR_SCANS scans (held to prior_cycle at every tick). Each report
    prints as a JSON line. Raises unless every row is finite (a stage row's
    wall and kernel ms, launches and host waits; a build row's ms and
    device ms; the solve diagnostics' times and the bcr / pcg solutions),
    both kernels launched in the profilers, bcr and pcg agree with a finite
    dense solution within SOLVE_AGREE_M, pcg (and a finite dense) solve ends
    within a fifth of its start's error (tests/test_graph.py's scale
    assertion), every CT variant's estimates are finite, and the prior
    funnels narrow gate by gate and end at the run's prior factors. Returns
    the kernels' launches over the profilers."""
    cfg = RoloConfig()
    stage_keys = ("wall_ms", "kernel_ms", "device_launches", "host_waits")
    torch.cuda.synchronize()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    t0 = time.perf_counter()
    front = _tool("torch_profile_frontend").profile(device, cfg, iters=PROFILE_ITERS)
    stages = _tool("torch_profile_stages").profile(device, iters=PROFILE_ITERS)
    build = _tool("torch_profile_build").profile(device, iters=PROFILE_ITERS)
    back = _tool("torch_profile_backend").profile(device, cfg, iters=1)
    proj = _tool("torch_profile_projection").profile(device, cfg, iters=PROFILE_ITERS)
    torch.cuda.synchronize()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    print(f"profilers: {time.perf_counter() - t0:.1f} s; launches {launches}")
    for name, report in (("torch_profile_frontend", front), ("torch_profile_stages", stages),
                         ("torch_profile_backend", back), ("torch_profile_projection", proj)):
        print(json.dumps({"tool": name, **report}))
        _finite_rows(name, report["stages"], stage_keys)
    print(json.dumps({"tool": "torch_profile_build", **build}))
    _finite_rows("torch_profile_build", build["rows"], ("ms",))
    _finite_rows("torch_profile_build", {k: r for k, r in build["rows"].items()
                                         if "keyed_matmul" in k or "searchsorted" in k},
                 ("device_ms",))
    if front["shapes"] != {"n": 8192, "valid": 5500, "voxel_capacity": 8192}:
        raise AssertionError(f"torch_profile_frontend shapes {front['shapes']}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the profilers")

    t1 = time.perf_counter()
    dense, graphsolve = _tool("torch_diag_dense_solve"), _tool("torch_diag_graphsolve")
    big = graphsolve.big_graph()
    for k in DIAG_BUCKETS:
        row, _, _ = dense.decompose(k, device, reps=1)
        dense.free(device)
        print(json.dumps({"tool": "torch_diag_dense_solve", **row}))
        _finite_rows("torch_diag_dense_solve", {k: row},
                     [key for key in row if key.startswith("ms_")] + ["chi2_bcr"])
        if np.isfinite(row["chi2_dense"]) and not (row["max_trans_diff_bcr_vs_dense_m"]
                                                   <= SOLVE_AGREE_M):
            raise AssertionError(f"dense solve diagnostic at K={k}: bcr "
                                 f"{row['max_trans_diff_bcr_vs_dense_m']} m from dense")
        methods = graphsolve.METHODS if k in PCG_BUCKETS else ("dense",)
        rows, sols = graphsolve.compare(k, big, device, reps=1, methods=methods, warm=False)
        gap = float((sols["pcg"].trans - sols["dense"].trans).abs().max()) if "pcg" in sols \
            else None
        print(json.dumps({"tool": "torch_diag_graphsolve", "k": k, "rows": rows,
                          "max_trans_diff_pcg_vs_dense_m": gap}))
        _finite_rows("torch_diag_graphsolve", rows, ("ms",))
        _finite_rows("torch_diag_graphsolve", {m: r for m, r in rows.items() if m == "pcg"},
                     ("max_t_err_m", "chi2"))
        solved = [r for r in rows.values() if r["method"] == "pcg" or np.isfinite(r["chi2"])]
        if (gap is not None and np.isfinite(rows["dense"]["chi2"]) and not gap <= SOLVE_AGREE_M
                ) or any(
                not r["max_t_err_m"] < 0.2 * r["start_max_t_err_m"] for r in solved):
            raise AssertionError(f"graph solve diagnostic at K={k}: pcg {gap} m from dense, "
                                 f"rows {rows}")
        del sols
        dense.free(device)
    ct = _tool("torch_diag_ct")
    ct_rows = ct.run_variants(ct.workload(N_CT_PAIRS, device, cfg), cfg.registration,
                              cfg.static.max_voxels)
    for row in ct_rows.values():
        if not (np.isfinite(row["rot"]).all() and np.isfinite(row["trans"]).all()):
            raise AssertionError(f"CT diagnostic: non-finite estimates in {row['variant']}")
        print(json.dumps({"tool": "torch_diag_ct",
                          **{k: v for k, v in row.items() if k not in ("rot", "trans")}}))
    prior = _tool("torch_diag_prior")
    sim = prior.sim_config(N_PRIOR_SCANS)
    scene = make_scene(sim, device)
    report = prior.run(list(generate_sequence(sim, device, scene)), cfg, device,
                       ground_map_points(sim, device, scene), check=True)
    print(json.dumps({"tool": "torch_diag_prior", **{k: v for k, v in report.items()
                                                      if k != "ticks"}}))
    funnels = [list(f.values()) for f in report["funnel"].values()]
    if (any(c != sorted(c, reverse=True) for c in funnels) or not report["ticks"]
            or report["funnel"]["associate"]["assoc_accepted"] != report["n_prior_factors"]):
        raise AssertionError(f"prior diagnostic: funnels {report['funnel']}, "
                             f"{report['n_prior_factors']} prior factors")
    print(f"diagnostics: {time.perf_counter() - t1:.1f} s")
    return launches


N_RANKS = 2  # phase 12
MULTIRANK_TIMEOUT_S = 300  # each group phase 12 spawns: a hang in a collective fails the phase
PAIR_FIELDS = ("src", "src_mask", "tgt", "tgt_mask", "gt_rot", "gt_trans")


def multirank_worker(spec: dict) -> int:
    """One rank of phase 12 (`chip_smoke.py --rank-worker SPEC`), pinned to
    its card by distributed_init, on the bench pairs the parent saved in
    spec["data"]: (a) registration_batch of this rank's slice, bit-equal to
    the parent's rows; (b) register_scan_pair_spmd over the group on the
    parent's median pair, within SPMD_ROT / SPMD_TRANS of its
    register_scan_pair and inside the bench gate; (c)
    dryrun_multichip(world). Any miss raises. Prints RESULT: the numbers,
    each step's wall, both kernels' launches over (a)-(c) and the card's
    memory."""
    torch.set_num_threads(1)
    configure_precision()
    rank, world = spec["rank"], spec["world"]
    distributed_init(f"localhost:{spec['port']}", world, rank, backend=spec["backend"])
    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    data = np.load(spec["data"])
    src, sm, tgt, tm, gt_rot, gt_trans = (torch.tensor(data[name], device=device)
                                          for name in PAIR_FIELDS)
    cfg = RoloConfig()
    reg = cfg.registration
    cap, k = cfg.static.max_voxels, reg.k_correspondences
    mesh = make_mesh(device_type=device.type)
    point_mesh = make_mesh(axis_names=("point",), device_type=device.type)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = time.perf_counter() - t0
        return out

    sync()
    keyed_matmul.launches = 0
    knn_moments.launches = 0
    got = timed("a registration_batch", lambda: registration_batch(
        *shard_registration_inputs(mesh, src, sm, tgt, tm, interval=0.2), cfg=reg,
        voxel_capacity=cap, k=k))
    b = src.shape[0] // world
    for name, field in zip(got._fields, got):
        if not torch.equal(field.cpu(), torch.from_numpy(data[f"want_{name}"][rank * b:
                                                                           (rank + 1) * b])):
            raise AssertionError(f"rank {rank}: registration_batch's {name} differs from the "
                                 "one-process batch's rows")
    i = int(data["pair"])
    zero = torch.zeros(3, device=device)
    dt = torch.tensor(0.2, device=device)
    sp = timed("b register_scan_pair_spmd", lambda: register_scan_pair_spmd(
        point_mesh, src[i], sm[i], tgt[i], tm[i], zero, zero, dt, dt, reg, cap, k))
    d_rot = float((sp.rot.cpu() - torch.from_numpy(data["one_rot"])).abs().max())
    d_trans = float((sp.trans.cpu() - torch.from_numpy(data["one_trans"])).abs().max())
    rot_err, trans_err = bench.pose_errors(sp.rot[None], sp.trans[None], gt_rot[i:i + 1],
                                           gt_trans[i:i + 1])
    if not (d_rot <= SPMD_ROT and d_trans <= SPMD_TRANS and rot_err[0] < bench.GATE_ROT_DEG
            and trans_err[0] < bench.GATE_TRANS_M):
        raise AssertionError(f"rank {rank}: register_scan_pair_spmd {d_rot:.3e} / {d_trans:.3e} "
                             f"from register_scan_pair, {rot_err[0]:.4f} deg / "
                             f"{trans_err[0]:.5f} m from the truth")
    timed("c dryrun_multichip", lambda: dryrun_multichip(world, device))
    sync()
    launches = {"keyed_sum": keyed_matmul.launches, "knn_moments": knn_moments.launches}
    torch.distributed.barrier()  # every rank alive while the card's processes are listed
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip() if rank == 0 and on_card else None
    torch.distributed.barrier()
    print("RESULT " + json.dumps({
        "rank": rank, "card": torch.cuda.current_device() if on_card else None, "pair": i,
        "spmd_rot": sp.rot.cpu().reshape(-1).tolist(), "spmd_trans": sp.trans.cpu().tolist(),
        "spmd_vs_one": [d_rot, d_trans], "spmd_err": [float(rot_err[0]), float(trans_err[0])],
        "wall_s": times, "launches": launches,
        "max_allocated_mb": torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else 0.0,
        "reserved_mb": torch.cuda.memory_reserved() / 2 ** 20 if on_card else 0.0,
        "nvidia_smi_apps": apps}),
        flush=True)
    torch.distributed.destroy_process_group()
    return 0


def _positive_rows(tool: str, rows) -> None:
    """Every number of every row finite and > 0 (flags and names aside)."""
    bad = [r for r in rows if not all(np.isfinite(v) and v > 0 for v in r.values()
                                      if isinstance(v, (int, float)) and not isinstance(v, bool))]
    if bad:
        raise AssertionError(f"{tool}: rows with a number that is not finite and > 0: {bad}")


def multirank(pairs, device):
    """Phase 12: the first run of the port's multi-rank paths on the card,
    at RoloConfig() as in the ranks. N_RANKS spawned ranks, on cards of
    their own over NCCL where the machine has them, else both on card 0
    over gloo, run `multirank_worker`'s (a)-(c) on phase 3's bench pairs,
    handed over in a temporary .npz with the one-process batch's result, the
    median pair and its register_scan_pair; (d) both kernels must have
    launched in every rank, and both ranks hold the same SPMD bits. (e)
    tools/torch_bench_weak_2proc.py at its defaults and
    tools/torch_bench_scaling.py at --ranks N_RANKS --repeats 1, each row
    printed as a JSON line, every number in it finite and > 0. A rank that
    exits non-zero, or a group that outlives MULTIRANK_TIMEOUT_S, raises.
    Returns each kernel's launches per rank. `device` "cpu" rehearses the
    phase on gloo (the kernels' plain versions: (d) fails)."""
    cfg = RoloConfig()
    reg = cfg.registration
    cap, k = cfg.static.max_voxels, reg.k_correspondences
    src, sm, tgt, tm, gt_rot, gt_trans = pairs
    on_card = device.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    scaling, weak = _tool("torch_bench_scaling"), _tool("torch_bench_weak_2proc")
    backend = launch.backend_for(N_RANKS, cards, device.type)
    print(f"multirank: {N_RANKS} ranks on {cards} card(s), "
          + ("a card each" if backend == "nccl" else f"{N_RANKS} ranks per card on card 0")
          + f", backend {backend}")
    want = bench.register_batch(src, sm, tgt, tm, torch.zeros_like(gt_trans), reg, cap, k)
    _, trans_err = bench.pose_errors(want.rot, want.trans, gt_rot, gt_trans)
    i = int(np.argsort(trans_err)[(len(trans_err) - 1) // 2])  # phase 8 (b)'s pair
    zero = torch.zeros(1, 3, device=src.device)
    dt = torch.full((1,), 0.2, device=src.device)
    one = register_scan_pair(src[i:i + 1], sm[i:i + 1], tgt[i:i + 1], tm[i:i + 1], zero, zero,
                             dt, dt, reg, cap, k)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_pairs.npz")
        np.savez(path, **{name: t.cpu().numpy() for name, t in zip(PAIR_FIELDS, pairs)},
                 **{f"want_{name}": f.cpu().numpy() for name, f in zip(want._fields, want)},
                 pair=i, one_rot=one.rot[0].cpu().numpy(), one_trans=one.trans[0].cpu().numpy())
        spec = {"world": N_RANKS, "backend": backend, "data": path, "device": device.type}
        outs = launch.run_ranks(
            lambda r, port: [sys.executable, os.path.abspath(__file__), "--rank-worker",
                             json.dumps({**spec, "rank": r, "port": port})],
            N_RANKS, MULTIRANK_TIMEOUT_S)
    results = [launch.result_of(out) for out in outs]
    for line in outs[0].splitlines():
        if line.startswith("dryrun_multichip"):
            print(f"multirank (c) rank 0: {line}")
    for res in results:
        print(f"multirank rank {res['rank']} on card {res['card']}: (a) registration_batch of "
              f"{src.shape[0] // N_RANKS} pairs bit-equal to the one-process rows; (b) spmd on "
              f"pair {res['pair']} vs register_scan_pair {res['spmd_vs_one'][0]:.3e} / "
              f"{res['spmd_vs_one'][1]:.3e} (limits {SPMD_ROT:g} / {SPMD_TRANS:g}), "
              f"{res['spmd_err'][0]:.4f} deg / {res['spmd_err'][1]:.5f} m from the truth; (c) "
              f"dryrun_multichip({N_RANKS}) ok; (d) launches {res['launches']}; wall s "
              f"{json.dumps({n: round(t, 3) for n, t in res['wall_s'].items()})}; card memory "
              f"max allocated {res['max_allocated_mb']:.1f} MB, reserved "
              f"{res['reserved_mb']:.1f} MB")
    print(f"multirank: nvidia-smi compute apps (pid, used memory) with both ranks alive: "
          f"{results[0]['nvidia_smi_apps']!r}; checks {time.perf_counter() - t0:.1f} s")
    if any((r["spmd_rot"], r["spmd_trans"]) != (results[0]["spmd_rot"], results[0]["spmd_trans"])
           for r in results):
        raise AssertionError("multirank (b): the ranks hold different SPMD results")
    for res in results:
        for name, n in res["launches"].items():
            if n <= 0:
                raise AssertionError(f"multirank (d): kernel {name} was not launched in rank "
                                     f"{res['rank']}")
    t1 = time.perf_counter()
    row = weak.measure(device=device.type, timeout=MULTIRANK_TIMEOUT_S)
    print(json.dumps({"tool": "torch_bench_weak_2proc", **row}))
    print(f"multirank (e): torch_bench_weak_2proc {time.perf_counter() - t1:.1f} s; "
          f"torch_bench_scaling --ranks {N_RANKS} --repeats 1:")
    t1 = time.perf_counter()
    rows, _ = scaling.measure(ranks=N_RANKS, repeats=1, device=device.type,
                              timeout=MULTIRANK_TIMEOUT_S)
    print(f"multirank (e): torch_bench_scaling {time.perf_counter() - t1:.1f} s")
    _positive_rows("torch_bench_weak_2proc", [row])
    _positive_rows("torch_bench_scaling", rows)
    return {name: [res["launches"][name] for res in results] for name in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is false)")
    # cuBLAS reproducible under deterministic algorithms (phase 6's restore check)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    configure_precision()
    smi = nvidia_smi_name_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"nvidia-smi: {smi}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        built = dict(zip(KERNELS, pool.map(cuda_build.build, KERNELS)))
    for name, (path, seconds) in built.items():
        print(f"build {name}: {seconds:.1f} s -> {path.name}")
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
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
    cases += [{**c, "case": f"B=1 {c['case']}"}
              for c in kernel_cases(cfg, *(t[:1] for t in pairs[:4]))]
    summary = check_kernels(cases)
    launches, rot_med, trans_med, rate = main_path(cfg, *pairs)
    print(f"registrations/s: {rate:.2f} at B={BATCH} on {smi} "
          f"(gate medians {rot_med:.4f} deg, {trans_med:.5f} m)")
    reg = cfg.registration
    prof = bench.profile_batch(*pairs[:4], reg, cfg.static.max_voxels, reg.k_correspondences)
    print(f"profile of one batch: {json.dumps(prof)}")
    odometry(cfg, clouds, frames)
    # one scan past the lap: phase 6's next scan after its checkpoint
    map_frames = list(generate_sequence(bench.bench_sim_config(N_MAP + 1), device))
    t0 = time.perf_counter()
    map_launches, _, _ = mapping(cfg, map_frames[:N_MAP])
    print(f"phase 5: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    slam, runtime_launches = runtime_lap(cfg, map_frames[:N_MAP])
    st = slam.backend_state
    bucket_ms = _tool("torch_bench_latency").solve_ms_by_bucket(st, cfg)
    print(f"runtime: solve_graph_host synced ms by bucket on the lap's final state "
          f"({int(st.db.count)} keyframes, {int(st.graph.loops.count)} loop / "
          f"{int(st.graph.priors.count)} prior factors; one untimed call, then the mean of 3) "
          f"{json.dumps(bucket_ms)}")
    del st
    restore_check(slam, map_frames[N_MAP])
    db = slam.backend_state.db
    n_kf = int(db.count)
    ground = (slam.live_ground.as_ground_map(), db.trans[:n_kf, :2].clone(),
              torch.atan2(db.rot[:n_kf, 1, 0], db.rot[:n_kf, 0, 0]))
    del slam, db
    print(f"phase 6: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    cli_on_recorded_data()
    print(f"phase 7: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    parallel_launches = parallel_slice(cfg, pairs, clouds, frames, ground, device)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s wall")
    del clouds, frames, ground
    t0 = time.perf_counter()
    batch_launches = batch_mapping(cfg, map_frames[:N_BATCH_SEQ * SEQ_LEN], device)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s wall")
    del map_frames
    t0 = time.perf_counter()
    latency_launches = latency_and_pipeline(device)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    profile_launches = profiles_and_diagnostics(device)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s wall")
    t0 = time.perf_counter()
    multirank_launches = multirank(pairs, device)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s wall")

    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         "launches_mapping": map_launches[name],
         "launches_per_lap_scan": map_launches[name] / N_MAP,
         "launches_runtime": runtime_launches[name],
         "launches_per_runtime_scan": runtime_launches[name] / N_MAP,
         "launches_parallel": parallel_launches[name],
         "launches_batch_mapping": batch_launches[name],
         "launches_latency": latency_launches[name],
         "launches_profile": profile_launches[name],
         "launches_multirank": multirank_launches[name], **summary[name]}
        for name in KERNELS]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(multirank_worker(json.loads(sys.argv[2])) if sys.argv[1:2] == ["--rank-worker"]
             else main())

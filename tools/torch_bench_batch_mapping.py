#!/usr/bin/env python3
"""Batched-mapping throughput of the PyTorch port on one NVIDIA GPU: the
counterpart of tools/bench_batch_mapping.py, with its synthetic worlds,
config and accuracy gate.

    python tools/torch_bench_batch_mapping.py [--batch 16] [--steps 4] [--reps 4]

B independent sequences' full backend_step (submap extraction,
scan-to-submap GN, keyframe gating, odometry factors), one batched call per
step for K steps, then one batched dense pose-graph solve over the B graphs.
Before timing, the gate: every sequence adds K keyframes within 0.25 m of
the truth, and each instance of the batch has the bits of the same sequence
stepped alone. Prints mapped scans/s and graph solves/s, batched and looped
(the B sequences one after another), beside the card's nvidia-smi name and
power limit, as one JSON line on stdout. Needs a CUDA device; writes no
file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GATE_M = 0.25  # tools/bench_batch_mapping.py:150


def world(seed, n_surf, n_corner):
    """tools/bench_batch_mapping.py:30-56: four walls (one diagonal, one the
    floor) and six vertical pillars, with 5 mm noise."""
    rng = np.random.default_rng(seed)
    walls = []
    for nv, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0, 0, 1), -1.5), ((0.7, 0.7, 0), 12.0)]:
        m = n_surf // 4
        nv = np.array(nv, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0] if abs(nv[2]) < 0.9 else [1.0, 0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        u = rng.uniform(-7, 7, (m, 2))
        walls.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    surf = np.concatenate(walls)[:n_surf].astype(np.float32)
    surf += rng.normal(0, 0.005, surf.shape).astype(np.float32)
    pts = []
    for px, py in [(4.0, 2.0), (6.0, -3.0), (9.0, 1.0), (3.0, -1.5), (7.5, 3.5), (2.0, 0.5)]:
        m = n_corner // 6
        z = rng.uniform(-1.0, 2.0, (m, 1))
        pts.append(np.concatenate([np.full((m, 1), px), np.full((m, 1), py), z], axis=1))
    corner = np.concatenate(pts)[:n_corner].astype(np.float32)
    corner += rng.normal(0, 0.005, corner.shape).astype(np.float32)
    return corner, surf


def config():
    """tools/bench_batch_mapping.py:80-89."""
    from rolo_tpu_torch.config import LoopConfig, MappingConfig, RoloConfig, StaticConfig

    return RoloConfig(
        mapping=MappingConfig(scan2map_max_iterations=8), loop=LoopConfig(enable=False),
        static=StaticConfig(max_raw_points=8192, max_corner_points=1024, max_surf_points=4096,
                            max_feature_points=5120, max_voxels=4096, max_keyframes=32,
                            max_submap_points=8192, max_loop_factors=8, max_prior_factors=8,
                            knn_query_chunk=512))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_batch_mapping.py needs a CUDA device")
    from rolo_tpu_torch.graph.solver import solve_pose_graph
    from rolo_tpu_torch.mapping.backend import backend_step, init_backend
    from rolo_tpu_torch.ops.pytree import tree_index, tree_leaves
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
    from rolo_tpu_torch.runtime.platform import configure_precision, nvidia_smi_name_power

    configure_precision()
    dev = torch.device("cuda")
    cfg = config()
    st = cfg.static
    b, k = args.batch, args.steps
    gt = np.zeros((b, k, 3), np.float32)
    worlds = [world(100 + i, st.max_surf_points, st.max_corner_points) for i in range(b)]
    for i in range(b):
        gt[i, :, 0] = (0.8 + 0.03 * i) * np.arange(k)
    noise = np.random.default_rng(0).normal(0, 0.02, (k, b, 3)).astype(np.float32)
    noise[0] = 0.0
    steps = []
    for s in range(k):
        corner = torch.tensor(np.stack([c - gt[i, s] for i, (c, _) in enumerate(worlds)]),
                              device=dev)
        surf = torch.tensor(np.stack([w - gt[i, s] for i, (_, w) in enumerate(worlds)]),
                            device=dev)
        ones = torch.ones(corner.shape[:2], dtype=torch.bool, device=dev)
        steps.append((PaddedCloud(corner, ones),
                      PaddedCloud(surf, torch.ones(surf.shape[:2], dtype=torch.bool, device=dev)),
                      torch.tensor(gt[:, s] + noise[s], device=dev), 0.5 * s))
    eye = torch.eye(3, device=dev).expand(b, 3, 3)

    def batched():
        states = init_backend(cfg, dev, batch=b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for corner, surf, guess, stamp in steps:
            states, _ = backend_step(states, corner, surf, surf, eye, guess, True, stamp, cfg)
        torch.cuda.synchronize()
        return states, time.perf_counter() - t0

    def looped():
        singles = [init_backend(cfg, dev) for _ in range(b)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for corner, surf, guess, stamp in steps:
            for i in range(b):
                one = PaddedCloud(corner.xyz[i], corner.mask[i])
                two = PaddedCloud(surf.xyz[i], surf.mask[i])
                singles[i], _ = backend_step(singles[i], one, two, two, eye[i], guess[i], True,
                                             stamp, cfg)
        torch.cuda.synchronize()
        return singles, time.perf_counter() - t0

    def solve(states):
        db = states.db
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve_pose_graph(states.graph, db.rot, db.trans, db.count, method="dense")
        torch.cuda.synchronize()
        return sol, time.perf_counter() - t0

    # the gate, which also warms every shape up
    states, _ = batched()
    singles, _ = looped()
    counts = states.db.count.cpu().numpy()
    kf = states.db.trans[:, :k].cpu().numpy()
    err = np.linalg.norm(kf - gt, axis=2)
    print(f"accuracy: kf_err max {err.max():.4f} m, counts {counts.min()}-{counts.max()}",
          file=sys.stderr)
    if not (counts == k).all():
        raise AssertionError(f"keyframe counts {counts.tolist()}, want {k} each")
    if not err.max() < GATE_M:
        raise AssertionError(f"mapped keyframes {err.max():.4f} m from the truth")
    for i, one in enumerate(singles):
        if not all(torch.equal(x, y) for x, y in zip(tree_leaves(tree_index(states, i)),
                                                     tree_leaves(one))):
            raise AssertionError(f"sequence {i} of the batch differs from its run alone")
    sol, _ = solve(states)
    drift = np.linalg.norm(sol.trans[:, :k].cpu().numpy() - kf, axis=2).max()
    if not (np.isfinite(drift) and drift < 0.05):
        raise AssertionError(f"the graph solve moved a keyframe {drift} m")

    batched_s = [batched()[1] for _ in range(args.reps)]
    looped_s = [looped()[1] for _ in range(args.reps)]
    solve_s = [solve(states)[1] for _ in range(args.reps)]
    solve_looped_s = [sum(solve(tree_index(states, i))[1] for i in range(b))
                      for _ in range(args.reps)]
    report = {
        "metric": "batched_mapping_scans_per_s",
        "value": b * k / float(np.median(batched_s)),
        "looped_scans_per_s": b * k / float(np.median(looped_s)),
        "graph_solves_per_s": b / float(np.median(solve_s)),
        "looped_graph_solves_per_s": b / float(np.median(solve_looped_s)),
        "batch_sequences": b, "steps_per_sequence": k, "reps": args.reps,
        "keyframe_err_max_m": float(err.max()), "solve_drift_max_m": float(drift),
        "capacities": {"corner": st.max_corner_points, "surf": st.max_surf_points,
                       "submap": st.max_submap_points, "keyframes": st.max_keyframes},
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_name_power(),
        "torch": torch.__version__,
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

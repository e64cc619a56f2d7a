#!/usr/bin/env python3
"""Component timing of the PyTorch port's mapping back-end on one NVIDIA GPU.

The counterpart of tools/profile_backend.py, with its state and rows:

    python tools/torch_profile_backend.py [--iters 5] [--keyframes 80] [--out FILE]

A back-end state at `RoloConfig()` capacities holding `--keyframes`
keyframes 0.6 m apart on a line (random clouds of 2,000 corner and 8,000
surface points each), then: one tiny kernel and a synchronize (the dispatch
round trip), `voxel_downsample` of a scan, `extract_submap`,
`scan2map_optimize` at the config's defaults, the scan-context descriptor,
`solve_pose_graph` over the keyframes, `backend_step`, `loop_closure_step`,
the descriptor of a 30,000-point raw cloud, `backend_step` with that raw
cloud, `backend_step` on an empty state (no scan-to-map), and
`add_keyframe`. The port writes a keyframe's row in place, so the last row
times `add_keyframe` alone where the reference adds a select over the whole
DB (its row keeps the reference's name). Each call of a step runs on the
same state: a step writes the row past the state's count, which the next
call writes again. Each row holds the mean wall ms per call over `--iters`
calls ending in one synchronize, and one synchronized call under
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

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

STAGES = ("nop dispatch roundtrip", "voxel_downsample surf [12k cap]",
          "extract_submap [64 kf -> 2x65536]", "scan2map_optimize (defaults)",
          "sc.make_descriptor", "solve_pose_graph [80 kf]", "backend_step (full)",
          "loop_closure_step", "sc.make_descriptor [32768 raw]",
          "backend_step (sc_cloud=raw 32768)", "backend_step (count=0: no scan2map)",
          "add_keyframe + tree where [full DB]")


def make_cloud(n: int, cap: int, seed: int, device, spread: float = 30.0):
    """profile_backend.py:45-51: min(n, cap) uniform points in a cube of
    half-width `spread`, padded to `cap`."""
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

    rng = np.random.default_rng(seed)
    n = min(n, cap)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    mask = np.zeros((cap,), bool)
    mask[:n] = True
    return PaddedCloud(torch.as_tensor(xyz, device=device), torch.as_tensor(mask, device=device))


def profile(device, cfg=None, n_kf: int = 80, iters: int = 5, raw_points: int = 30000,
            raw_cap: int = 32768) -> dict:
    """Every row of profile_backend.py:55-140 on `device`, as a report."""
    from rolo_tpu_torch.bench import stage_row
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.geometry.se3 import SE3
    from rolo_tpu_torch.graph.solver import solve_pose_graph
    from rolo_tpu_torch.loop import scancontext as sc
    from rolo_tpu_torch.mapping import backend
    from rolo_tpu_torch.mapping.keyframes import add_keyframe, extract_submap
    from rolo_tpu_torch.mapping.scan2map import scan2map_optimize
    from rolo_tpu_torch.pointcloud.features import voxel_downsample
    from rolo_tpu_torch.runtime.platform import bench_metadata

    device = torch.device(device)
    cfg = RoloConfig() if cfg is None else cfg
    st, m, lc = cfg.static, cfg.mapping, cfg.loop
    eye = torch.eye(3, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state = backend.init_backend(cfg, device)
    db = state.db
    for i in range(n_kf):
        c = make_cloud(2000, st.max_corner_points, i, device)
        s = make_cloud(8000, st.max_surf_points, 100 + i, device)
        pose = SE3(eye, torch.tensor([0.6 * i, 0.0, 0.0], device=device))
        db = add_keyframe(db, pose, torch.tensor(0.15 * i, device=device), c, s)
    sync()
    query_t = torch.tensor([0.6 * n_kf, 0.0, 0.0], device=device)
    query_time = torch.tensor(0.15 * n_kf, device=device)
    state = state._replace(db=db, rpy=torch.zeros(3, device=device), xyz=query_t.clone())
    corner = make_cloud(2000, st.max_corner_points, 999, device)
    surf = make_cloud(8000, st.max_surf_points, 998, device)
    rows = {}

    def timeit(name, fn, n_iters=iters):
        rows[name], out = stage_row(fn, device, n_iters)
        return out

    zero = torch.zeros((), device=device)

    def nop():
        out = zero + 1.0
        sync()
        return out

    timeit("nop dispatch roundtrip", nop, 20)
    timeit("voxel_downsample surf [12k cap]",
           lambda: voxel_downsample(surf, m.mapping_surf_leaf_size, st.max_surf_points))

    def submap(db_, t, tt):
        return extract_submap(db_, t, tt, m.surrounding_keyframe_search_radius,
                              m.surrounding_keyframe_recency_sec,
                              max_nearby=m.surrounding_keyframe_max_nearby,
                              corner_out_cap=st.max_submap_points,
                              surf_out_cap=st.max_submap_points,
                              corner_leaf=m.mapping_corner_leaf_size,
                              surf_leaf=m.mapping_surf_leaf_size)

    sub_c, sub_s = timeit("extract_submap [64 kf -> 2x65536]",
                          lambda: submap(db, query_t, query_time))
    timeit("scan2map_optimize (defaults)", lambda: scan2map_optimize(
        torch.zeros(3, device=device), query_t, corner.xyz, corner.mask, surf.xyz, surf.mask,
        sub_c, sub_s, max_iterations=m.scan2map_max_iterations,
        degeneracy_threshold=m.degeneracy_eigen_threshold, chunk=st.knn_query_chunk,
        rebind_every=m.scan2map_rebind_every, approx_knn=m.approx_knn,
        n_candidates=m.scan2map_candidates))

    def descriptor(cloud):
        return sc.make_descriptor(cloud.xyz, cloud.mask, lc.sc_num_ring, lc.sc_num_sector,
                                  lc.sc_max_radius, lc.sc_lidar_height)

    timeit("sc.make_descriptor", lambda: descriptor(surf))
    timeit("solve_pose_graph [80 kf]",
           lambda: solve_pose_graph(state.graph, db.rot, db.trans, db.count))

    def bstep(s, sc_cloud):
        return backend.backend_step(s, corner, surf, sc_cloud, eye, query_t, True, query_time,
                                    cfg)[1].trans

    timeit("backend_step (full)", lambda: bstep(state, surf))
    timeit("loop_closure_step", lambda: backend.loop_closure_step(state, cfg)[0].pending_solve)
    raw_cloud = make_cloud(raw_points, raw_cap, 997, device)
    timeit("sc.make_descriptor [32768 raw]", lambda: descriptor(raw_cloud))
    timeit("backend_step (sc_cloud=raw 32768)", lambda: bstep(state, raw_cloud))
    fresh = backend.init_backend(cfg, device)
    timeit("backend_step (count=0: no scan2map)", lambda: bstep(fresh, surf))
    timeit("add_keyframe + tree where [full DB]", lambda: add_keyframe(
        state.db, SE3(eye, query_t), query_time, corner, surf).count)
    return {"shapes": {"keyframes": int(db.count), "keyframe_capacity": int(db.capacity),
                       "raw_points": min(raw_points, raw_cap)},
            "stage_ms": {name: r["wall_ms"] for name, r in rows.items()},
            "stages": rows, "machine": bench_metadata()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--keyframes", type=int, default=80)
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_backend.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import configure_precision

    configure_precision()
    report = profile(torch.device("cuda"), n_kf=args.keyframes, iters=args.iters)
    for stage, row in report["stages"].items():
        print(json.dumps({"stage": stage, **row}))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Per-stage breakdown of the PyTorch port's front-end step on one NVIDIA GPU.

The counterpart of tools/profile_frontend.py, with its cloud, stages and
report:

    python tools/torch_profile_frontend.py [--iters 20] [--n 8192] [--valid 5500]
        [--out FILE]

Times each stage of `frontend/odometry.scan_step` at the pipeline's shapes
(`--n` feature slots, `--valid` of them valid, `RoloConfig()`'s voxel
capacity) on a ring-structured cloud at lidar ranges and its copy rotated
0.02 rad and shifted: the covariances (kernel K2), the polar and fine voxel
builds (K1), the correspondence contexts, the rotation LM, the polar and
fine CT translation LMs, the covariance congruence, and the whole
`scan_step`. Each stage row holds the mean wall ms per call over `--iters`
calls ending in one synchronize, and one synchronized call under
torch.profiler: its kernel ms, launches, the host's waits for the card and
the top kernels (`rolo_tpu_torch.bench.stage_row`). The LM loops read a
flag on the host every outer iteration, so a stage's wall time holds its
launch latency and those waits beside its kernels.

Prints JSON lines on stdout (one per stage, the iteration counts, the sum of
the stages against the whole step, then the report), beside the card's
nvidia-smi name and power limit. Writes the report to `--out` only when
given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

STAGES = ("cov_moments", "voxel_build_polar", "make_context", "lm_rotation", "lm_ct_translation",
          "voxel_build_fine", "make_context_fine", "lm_ct_fine", "sym3_congruence",
          "scan_step_total")


def ring_cloud(n: int, valid: int):
    """profile_frontend.py:52-69: (src [n, 3], tgt [n, 3], mask [n]) numpy,
    the first `valid` slots a ring-structured cloud at lidar ranges and the
    target that cloud rotated 0.02 rad about z and shifted."""
    rng = np.random.default_rng(0)
    az = rng.uniform(0, 2 * np.pi, valid)
    el = rng.uniform(-0.4, 0.26, valid)
    r = rng.uniform(3.0, 60.0, valid)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1)
    src = np.zeros((n, 3), np.float32)
    src[:valid] = pts
    mask = np.zeros((n,), bool)
    mask[:valid] = True
    ang = 0.02
    c, s = np.cos(ang), np.sin(ang)
    rot_gt = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = np.zeros_like(src)
    tgt[:valid] = pts @ rot_gt.T + np.array([0.15, 0.03, 0.01], np.float32)
    return src, tgt, mask


def profile(device, cfg=None, n: int = 8192, valid: int = 5500, iters: int = 20) -> dict:
    """Every stage of profile_frontend.py:71-146 on `device`, as a report:
    shapes, `stage_ms` (the mean wall ms per stage), `stages` (each stage's
    row), the rotation and CT iteration counts and the machine."""
    from rolo_tpu_torch.bench import stage_row
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.frontend import odometry
    from rolo_tpu_torch.ops import sym3
    from rolo_tpu_torch.registration import gicp, lm
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.voxel.knn import estimate_cov6
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

    device = torch.device(device)
    cfg = RoloConfig() if cfg is None else cfg
    rc = cfg.registration
    cap = cfg.static.max_voxels
    src_np, tgt_np, mask_np = ring_cloud(n, valid)
    src = torch.as_tensor(src_np, device=device)[None]
    tgt = torch.as_tensor(tgt_np, device=device)[None]
    mask = torch.as_tensor(mask_np, device=device)[None]
    polar = tuple(rc.polar_resolution)
    eye = torch.eye(3, device=device)[None]
    zero = torch.zeros(1, 3, device=device)
    dt = torch.full((1,), 0.1, device=device)
    rows = {}

    def timeit(name, fn):
        rows[name], out = stage_row(fn, device, iters)
        return out

    def cov(x):
        return estimate_cov6(x, mask, k=rc.k_correspondences, method=rc.regularization)

    def ct(ctx):
        return lm.lm_translation_rebind(
            ctx, eye, zero, zero, zero, dt, dt, rc.ct_lambda,
            rebind_rounds=min(rc.ct_rebind_rounds, 2), max_outer=min(rc.max_outer_iterations, 16),
            max_inner=rc.lm_max_inner_iterations, trans_eps=rc.transformation_epsilon,
            init_lambda_factor=rc.lm_init_lambda_factor)

    src_cov = timeit("cov_moments", lambda: cov(src))
    tgt_cov = cov(tgt)
    vmap = timeit("voxel_build_polar", lambda: build_voxel_map(
        tgt, tgt_cov, mask, cap, polar_res=polar, resolution=rc.voxel_resolution))
    ctx = timeit("make_context", lambda: gicp.make_context(
        src, mask, src_cov, vmap, polar_res=polar, resolution=rc.voxel_resolution,
        neighbor_search=rc.neighbor_search))
    rot_res = timeit("lm_rotation", lambda: lm.lm_register_rotation(
        ctx, eye, zero, max_outer=rc.max_outer_iterations, max_inner=rc.lm_max_inner_iterations,
        rot_eps=rc.rotation_epsilon, trans_eps=rc.transformation_epsilon,
        init_lambda_factor=rc.lm_init_lambda_factor))
    ct_res = timeit("lm_ct_translation", lambda: ct(ctx))
    if rc.ct_fine_resolution > 0:
        vmap_f = timeit("voxel_build_fine", lambda: build_voxel_map(
            tgt, tgt_cov, mask, cap, polar_res=None, resolution=rc.ct_fine_resolution))
        ctx_f = timeit("make_context_fine", lambda: gicp.make_context(
            src, mask, src_cov, vmap_f, polar_res=None, resolution=rc.ct_fine_resolution,
            neighbor_search=rc.ct_fine_neighbors))
        timeit("lm_ct_fine", lambda: ct(ctx_f))
    timeit("sym3_congruence", lambda: sym3.congruence(rot_res.rot, src_cov))

    state = odometry.init_state(n, device)
    state1, _ = odometry.scan_step(state, tgt[0], mask[0], 0.1, rc, cap, rc.k_correspondences)
    timeit("scan_step_total", lambda: odometry.scan_step(state1, src[0], mask[0], 0.1, rc, cap,
                                                          rc.k_correspondences))
    known = sum(r["wall_ms"] for name, r in rows.items() if name != "scan_step_total")
    return {"shapes": {"n": n, "valid": valid, "voxel_capacity": cap},
            "stage_ms": {name: r["wall_ms"] for name, r in rows.items()},
            "stages": rows,
            "rotation_iterations": int(rot_res.iterations[0]),
            "ct_iterations": int(ct_res.iterations[0]),
            "sum_of_stages_ms": known,
            "machine": bench_metadata()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--n", type=int, default=8192, help="feature capacity")
    ap.add_argument("--valid", type=int, default=5500, help="valid features (pipeline-typical)")
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_frontend.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import configure_precision

    configure_precision()
    report = profile(torch.device("cuda"), n=args.n, valid=args.valid, iters=args.iters)
    for stage, row in report["stages"].items():
        print(json.dumps({"stage": stage, **row}))
    print(json.dumps({"rotation_iterations": report["rotation_iterations"],
                      "ct_iterations": report["ct_iterations"]}))
    print(json.dumps({"sum_of_stages_vs_scan_step": {
        "sum_of_stages_ms": report["sum_of_stages_ms"],
        "scan_step_ms": report["stage_ms"]["scan_step_total"]}}))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

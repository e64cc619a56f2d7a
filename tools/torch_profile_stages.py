#!/usr/bin/env python3
"""Stage timing of the PyTorch port's scan-pair registration on one NVIDIA GPU.

The counterpart of tools/profile_stages.py, with its workload and stages:

    python tools/torch_profile_stages.py [--iters 5] [--batch 16] [--n 4096] [--cap 8192]
        [--out FILE]

`--batch` pairs of synthetic four-plane feature clouds (`--n` points each)
against their copies rotated 0.03 rad and shifted, at `--cap` voxel slots:
the covariances of source and target (kernel K2), the polar voxel build
(K1), one correspondence binding, one rotation linearization, one error
evaluation, the rotation LM, the CT translation LM with rebinding, and the
whole `register_scan_pair`. Each stage row holds the mean wall ms per call
over `--iters` calls ending in one synchronize, and one synchronized call
under torch.profiler: kernel ms, launches, the host's waits and the top
kernels (`rolo_tpu_torch.bench.stage_row`).

Prints JSON lines on stdout (one per stage, the iteration counts, then the
report), beside the card's nvidia-smi name and power limit. Writes the
report to `--out` only when given. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

STAGES = ("estimate_cov6 (src+tgt)", "build_voxel_map", "update_correspondences (1 bind)",
          "so3_linearize (1 iter)", "compute_error (1 trial)", "lm_register_rotation",
          "lm_translation_rebind", "register_scan_pair (full)")


def pairs(batch: int, n: int):
    """profile_stages.py:42-49: (src, tgt) numpy [batch, n, 3], the synthetic
    feature clouds of seeds 0..batch-1 and their copies rotated 0.03 rad
    about z and shifted."""
    from rolo_tpu_torch.graft_entry import _synthetic_features

    src = np.stack([_synthetic_features(n, seed=i) for i in range(batch)])
    ang = 0.03
    c, s = np.cos(ang), np.sin(ang)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return src, src @ r.T + np.array([0.3, 0.05, 0.0], np.float32)


def profile(device, batch: int = 16, n: int = 4096, cap: int = 8192, iters: int = 5,
            cfg=None) -> dict:
    """Every stage of profile_stages.py:52-111 on `device`, as a report."""
    from rolo_tpu_torch.bench import stage_row
    from rolo_tpu_torch.config import RegistrationConfig
    from rolo_tpu_torch.registration import gicp, lm
    from rolo_tpu_torch.registration.rotgicp import register_scan_pair
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.voxel.knn import estimate_cov6
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

    device = torch.device(device)
    cfg = RegistrationConfig() if cfg is None else cfg
    src_np, tgt_np = pairs(batch, n)
    src = torch.as_tensor(src_np, device=device)
    tgt = torch.as_tensor(tgt_np, device=device)
    mask = torch.ones(batch, n, dtype=torch.bool, device=device)
    zeros = torch.zeros(batch, 3, device=device)
    eye = torch.eye(3, device=device).expand(batch, 3, 3)
    dt = torch.full((batch,), 0.1, device=device)
    polar = tuple(cfg.polar_resolution)
    rows = {}

    def timeit(name, fn):
        rows[name], out = stage_row(fn, device, iters)
        return out

    def cov(x):
        return estimate_cov6(x, mask, k=20, method=cfg.regularization)

    src_cov, tgt_cov = timeit("estimate_cov6 (src+tgt)", lambda: (cov(src), cov(tgt)))
    vmaps = timeit("build_voxel_map", lambda: build_voxel_map(
        tgt, tgt_cov, mask, cap, polar_res=polar, resolution=cfg.voxel_resolution))
    ctx = gicp.make_context(src, mask, src_cov, vmaps, polar_res=polar,
                            resolution=cfg.voxel_resolution, neighbor_search=cfg.neighbor_search)
    corr = timeit("update_correspondences (1 bind)",
                  lambda: gicp.update_correspondences(ctx, eye, zeros))
    timeit("so3_linearize (1 iter)", lambda: gicp.so3_linearize(ctx, corr, eye, zeros))
    timeit("compute_error (1 trial)", lambda: gicp.compute_error(ctx, corr, eye, zeros))
    rot_res = timeit("lm_register_rotation", lambda: lm.lm_register_rotation(
        ctx, eye, zeros, max_outer=cfg.max_outer_iterations,
        max_inner=cfg.lm_max_inner_iterations, rot_eps=cfg.rotation_epsilon,
        trans_eps=cfg.transformation_epsilon, init_lambda_factor=cfg.lm_init_lambda_factor))
    ct_res = timeit("lm_translation_rebind", lambda: lm.lm_translation_rebind(
        ctx, rot_res.rot, zeros, zeros, zeros, dt, dt, cfg.ct_lambda,
        rebind_rounds=cfg.ct_rebind_rounds, max_outer=cfg.max_outer_iterations,
        max_inner=cfg.lm_max_inner_iterations, trans_eps=cfg.transformation_epsilon,
        init_lambda_factor=cfg.lm_init_lambda_factor))
    timeit("register_scan_pair (full)", lambda: register_scan_pair(
        src, mask, tgt, mask, zeros, zeros, dt, dt, cfg, cap, 20))
    return {"shapes": {"batch": batch, "n": n, "voxel_capacity": cap},
            "stage_ms": {name: r["wall_ms"] for name, r in rows.items()},
            "stages": rows,
            "rotation_iterations": rot_res.iterations.tolist(),
            "ct_iterations": ct_res.iterations.tolist(),
            "machine": bench_metadata()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--cap", type=int, default=8192)
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_stages.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import configure_precision

    configure_precision()
    report = profile(torch.device("cuda"), args.batch, args.n, args.cap, args.iters)
    for stage, row in report["stages"].items():
        print(json.dumps({"stage": stage, **row}))
    print(json.dumps({"rotation_iterations": report["rotation_iterations"],
                      "ct_iterations": report["ct_iterations"]}))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

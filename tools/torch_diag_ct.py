#!/usr/bin/env python3
"""The PyTorch port's CT-translation error on the bench workload, variant by variant.

The counterpart of tools/diag_ct.py, with its variants and workload:

    python tools/torch_diag_ct.py [--batch 16]

Each variant registers the bench workload's stride-2 scan pairs (32-beam
raycast scans 0.2 s apart, features at `RoloConfig()` capacities) from a
zero initial guess, and reports the median rotation error and the median,
mean and largest translation error against the ground truth:

  A  default                shipped path: the CT residual on the UNROTATED
                            source, step = guess + ct.
  B  rotated-residual       the residual on the rotated source, step = R
                            guess + ct (a consistent rigid model).
  C  B + ct_lambda=0        without the velocity-continuity term.
  D  B + rebind_rounds=8    more correspondence rebinding.
  E  A + true last_t0       the constant-velocity prior centred on the true
                            previous step (the pipeline's regime).
  F  B + true last_t0
  P  cascade                B, then a fine uniform stage (0.25 m, direct7).
  R  point-to-plane         B, then a translation-only Gauss-Newton on
                            5-NN plane fits (`scan2map.surf_bind` /
                            `surf_eval`).

The rotated residual goes through `lm_translation_rebind`'s
`ct_linearize_fn` / `ct_error_fn` hooks: correspondences are bound at the
rotation LM's rotation, and the CT terms are evaluated on the rotated
source. The true previous step of each pair is the ground-truth motion of
the stride-2 pair before it, so the pairs start `stride` scans into the
sequence. Prints one JSON line per variant, beside the card's nvidia-smi
name and power limit. Writes no file. Needs a CUDA device.
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

# (name, RegistrationConfig changes, rotated residual, true last_t0, stage options)
VARIANTS = (
    ("A default (unrotated, lam=0.3)", {}, False, False, {}),
    ("B rotated-residual", {}, True, False, {}),
    ("C B + ct_lambda=0", {"ct_lambda": 0.0}, True, False, {}),
    ("D B + rebind_rounds=8", {"ct_rebind_rounds": 8}, True, False, {}),
    ("E A + true last_t0", {}, False, True, {}),
    ("F B + true last_t0", {}, True, True, {}),
    ("P cascade polar->uni0.25 d7", {}, True, False,
     {"trans_voxel": "cascade", "trans_resolution": 0.25, "trans_neighbors": "direct7"}),
    ("R polar -> point-to-plane", {}, True, False, {"trans_voxel": "p2p"}),
)


def register_variant(src_xyz, src_mask, tgt_xyz, tgt_mask, init_t, last_t, dt, cfg,
                     voxel_capacity: int, k: int, rotated_residual: bool,
                     trans_voxel: str = "polar", trans_resolution: float = 1.0,
                     trans_neighbors: str = "direct1"):
    """diag_ct.py:46-168 over a batch: clouds [B, N, 3], init_t / last_t
    [B, 3], dt [B] -> (rot [B, 3, 3], trans [B, 3])."""
    from rolo_tpu_torch.mapping.scan2map import surf_bind, surf_eval
    from rolo_tpu_torch.ops import sym3
    from rolo_tpu_torch.ops.linalg import small_matmul
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
    from rolo_tpu_torch.registration import gicp, lm
    from rolo_tpu_torch.voxel.knn import estimate_cov6
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

    bsz, dev = src_xyz.shape[0], src_xyz.device
    src_cov = estimate_cov6(src_xyz, src_mask, k=k, method=cfg.regularization)
    tgt_cov = estimate_cov6(tgt_xyz, tgt_mask, k=k, method=cfg.regularization)
    polar = tuple(cfg.polar_resolution) if cfg.voxel_type == "polar" else None
    vmap = build_voxel_map(tgt_xyz, tgt_cov, tgt_mask, voxel_capacity, polar_res=polar,
                           resolution=cfg.voxel_resolution)
    ctx = gicp.make_context(src_xyz, src_mask, src_cov, vmap, polar_res=polar,
                            resolution=cfg.voxel_resolution, neighbor_search=cfg.neighbor_search)
    eye = torch.eye(3, device=dev).expand(bsz, 3, 3)
    zero = torch.zeros(bsz, 3, device=dev)
    rot = lm.lm_register_rotation(
        ctx, eye, zero, max_outer=cfg.max_outer_iterations,
        max_inner=cfg.lm_max_inner_iterations, rot_eps=cfg.rotation_epsilon,
        trans_eps=cfg.transformation_epsilon, init_lambda_factor=cfg.lm_init_lambda_factor).rot
    budget = dict(rebind_rounds=cfg.ct_rebind_rounds, max_outer=cfg.max_outer_iterations,
                  max_inner=cfg.lm_max_inner_iterations, trans_eps=cfg.transformation_epsilon,
                  init_lambda_factor=cfg.lm_init_lambda_factor)
    rot_init = small_matmul(rot, init_t[..., None])[..., 0]
    if not rotated_residual:
        ct = lm.lm_translation_rebind(ctx, rot, zero, init_t, last_t, dt, dt, cfg.ct_lambda,
                                      **budget)
        return rot, init_t + ct.trans

    # the CT terms on the rotated source; correspondences bound at `rot`
    rotated = ctx._replace(src_t=small_matmul(rot, ctx.src_t),
                           src_cov6=sym3.congruence(rot, ctx.src_cov6))
    hooks = dict(ct_linearize_fn=lambda _, *a, **kw: gicp.ct_linearize(rotated, *a, **kw),
                 ct_error_fn=lambda _, *a, **kw: gicp.ct_error(rotated, *a, **kw))
    ct1 = lm.lm_translation_rebind(ctx, rot, zero, rot_init, last_t, dt, dt, cfg.ct_lambda,
                                   **budget, **hooks)
    src_r = rotated.src_t.transpose(1, 2)
    if trans_voxel == "cascade":  # a fine uniform stage after the polar one
        vmap_t = build_voxel_map(tgt_xyz, tgt_cov, tgt_mask, voxel_capacity, polar_res=None,
                                 resolution=trans_resolution)
        ctx_u = gicp.make_context(src_r, src_mask, rotated.src_cov6, vmap_t, polar_res=None,
                                  resolution=trans_resolution, neighbor_search=trans_neighbors)
        ct2 = lm.lm_translation_rebind(ctx_u, eye, ct1.trans, rot_init, last_t, dt, dt,
                                       cfg.ct_lambda, **budget)
        return rot, rot_init + ct2.trans
    if trans_voxel == "p2p":  # point-to-plane refinement on 5-NN plane fits
        tgt_cloud = PaddedCloud(tgt_xyz, tgt_mask)
        t = ct1.trans
        for _ in range(4):
            sb = surf_bind(src_r + t[:, None], src_mask, tgt_cloud, eye, zero, approx_knn=True)
            for _ in range(2):
                f = surf_eval(sb, src_r + t[:, None], eye, zero)
                w = f.valid.to(src_r.dtype)
                h = torch.einsum("bn,bni,bnj->bij", w, f.direction, f.direction)
                b = torch.einsum("bn,bni,bn->bi", w, f.direction, f.residual)
                t = t + torch.linalg.solve(h + 1e-6 * eye, -b)
        return rot, rot_init + t
    return rot, rot_init + ct1.trans


def workload(batch: int, device, cfg=None, sim=None, stride: int = 2):
    """The bench workload's stride-2 pairs, starting `stride` scans in:
    (src, src_mask, tgt, tgt_mask, gt_rot, gt_trans, last_t) with last_t
    [B, 3] the true previous step of each pair."""
    from rolo_tpu_torch import bench
    from rolo_tpu_torch.config import RoloConfig

    cfg = RoloConfig() if cfg is None else cfg
    sim = bench.bench_sim_config(batch + 2 * stride) if sim is None else sim
    clouds, frames = bench.make_features(sim, cfg, device)
    pairs = bench.stack_pairs(clouds[stride:], frames[stride:], batch, stride)
    last = torch.stack([bench.gt_relative(frames[i].gt_rot, frames[i].gt_trans,
                                          frames[i + stride].gt_rot,
                                          frames[i + stride].gt_trans)[1]
                        for i in range(batch)])
    return (*pairs, last)


def run_variants(pairs, cfg, voxel_capacity: int, k: int = 20, dt: float = 0.2,
                 variants=VARIANTS) -> dict:
    """Each variant on `pairs` (a `workload()`): {name: row}, each row with
    the rotation error (deg) and translation error (m) statistics, the wall
    seconds, and the per-pair estimates (`rot`, `trans`)."""
    from rolo_tpu_torch.bench import pose_errors

    src, src_mask, tgt, tgt_mask, gt_rot, gt_trans, last_true = pairs
    bsz, dev = src.shape[0], src.device
    dts = torch.full((bsz,), dt, device=dev)
    zero = torch.zeros(bsz, 3, device=dev)
    rows = {}
    for name, changes, rotated, true_last, kw in variants:
        reg = dataclasses.replace(cfg, **changes)
        t0 = time.perf_counter()
        rot, trans = register_variant(src, src_mask, tgt, tgt_mask, zero,
                                      last_true if true_last else zero, dts, reg,
                                      voxel_capacity, k, rotated, **kw)
        rot_err, terr = pose_errors(rot, trans, gt_rot, gt_trans)
        rows[name] = {"variant": name, "rot_med_deg": float(np.median(rot_err)),
                      "trans_med_m": float(np.median(terr)), "trans_mean_m": float(np.mean(terr)),
                      "trans_max_m": float(np.max(terr)), "wall_s": time.perf_counter() - t0,
                      "rot": rot.cpu().numpy(), "trans": trans.cpu().numpy()}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diag_ct.py needs a CUDA device")
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.platform import bench_metadata, configure_precision

    configure_precision()
    cfg = RoloConfig()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    pairs = workload(args.batch, device, cfg)
    gt = pairs[5].norm(dim=1)
    print(json.dumps({"workload_s": time.perf_counter() - t0, "pairs": args.batch,
                      "median_gt_trans_m": float(gt.median())}), flush=True)
    for row in run_variants(pairs, cfg.registration, cfg.static.max_voxels).values():
        print(json.dumps({k: v for k, v in row.items() if k not in ("rot", "trans")}), flush=True)
    print(json.dumps({"machine": bench_metadata()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Top-level rot-GICP scan-pair registration, torch port of
`rolo_tpu/registration/rotgicp.py`: per-point covariances (kernel K2), a
polar voxel map of the target (kernel K1), alternating SO(3) LM and
continuous-time translation LM, and a fine uniform-voxel translation stage;
and `register_se3`, full SE(3) VGICP on the same covariances and map.
Every function takes a batch of B scan pairs. In an active tracer
(`runtime.profiling`) the stages are the spans `frontend.rotation`,
`frontend.translation` (each alternation round) and `frontend.fine`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RegistrationConfig
from ..ops import sym3
from ..ops.linalg import small_matmul
from ..runtime import profiling
from ..voxel.knn import estimate_cov6
from ..voxel.voxelmap import build_voxel_map
from . import gicp, lm


class ScanPairResult(NamedTuple):
    """rot [B, 3, 3] and trans [B, 3] map the source frame into the target
    frame: tgt ~ rot @ src + trans."""

    rot: torch.Tensor
    trans: torch.Tensor
    rot_error: torch.Tensor
    ct_error: torch.Tensor
    rot_iterations: torch.Tensor
    ct_iterations: torch.Tensor
    converged: torch.Tensor


def _rotate(xyz: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Row points [B, N, 3] -> (R p) rows, i.e. xyz @ R^T."""
    return small_matmul(xyz, rot.transpose(1, 2))


def register_features(src_xyz, src_mask, src_cov, tgt_xyz, tgt_mask, tgt_cov,
                      init_translation, last_translation, interval_tn, interval_tn_1,
                      cfg: RegistrationConfig, voxel_capacity: int,
                      objective: Optional[Tuple] = None) -> ScanPairResult:
    """Shared registration core (rotgicp.py:46-183). src/tgt_xyz [B, N, 3],
    masks [B, N], covs [B, 6, N], translations [B, 3], intervals [B].

    `objective` = (so3_linearize, compute_error, ct_linearize, ct_error)
    replaces the objective reductions in every LM stage (lm.py's hooks);
    parallel/spmd.py passes all-reducing ones for a source split over
    ranks. None is gicp's own."""
    so3_lin, err_fn, ct_lin, ct_err = objective if objective is not None else (None,) * 4
    bsz = src_xyz.shape[0]
    dt, dev = src_xyz.dtype, src_xyz.device
    eye = torch.eye(3, dtype=dt, device=dev).expand(bsz, 3, 3)
    zero3 = torch.zeros(bsz, 3, dtype=dt, device=dev)
    polar_res = tuple(cfg.polar_resolution) if cfg.voxel_type == "polar" else None
    vmap = build_voxel_map(tgt_xyz, tgt_cov, tgt_mask, voxel_capacity, polar_res=polar_res,
                           resolution=cfg.voxel_resolution)

    # Multi-stage flows cap the polar CT stages (rotgicp.py:93-100).
    multi = cfg.alt_rounds > 1 or cfg.ct_fine_resolution > 0
    ct_outer = min(cfg.max_outer_iterations, 16) if multi else cfg.max_outer_iterations
    ct_rebinds = min(cfg.ct_rebind_rounds, 2) if multi else cfg.ct_rebind_rounds

    def one_round(rot, t, active):
        with profiling.span("frontend.rotation", sync=lambda: rot_res.rot):
            shift = small_matmul(rot.transpose(1, 2), t[..., None])[..., 0]
            ctx_r = gicp.make_context(src_xyz + shift[:, None, :], src_mask, src_cov, vmap,
                                      polar_res=polar_res, resolution=cfg.voxel_resolution,
                                      neighbor_search=cfg.neighbor_search)
            rot_res = lm.lm_register_rotation(
                ctx_r, rot, zero3, max_outer=cfg.max_outer_iterations,
                max_inner=cfg.lm_max_inner_iterations, rot_eps=cfg.rotation_epsilon,
                trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor, active=active,
                linearize_fn=so3_lin, error_fn=err_fn)
        rot = rot_res.rot
        with profiling.span("frontend.translation", sync=lambda: ct_res.trans):
            ctx_t = gicp.make_context(_rotate(src_xyz, rot), src_mask,
                                      sym3.congruence(rot, src_cov), vmap, polar_res=polar_res,
                                      resolution=cfg.voxel_resolution,
                                      neighbor_search=cfg.neighbor_search)
            ct_res = lm.lm_translation_rebind(
                ctx_t, eye, t, zero3, last_translation, interval_tn, interval_tn_1,
                cfg.ct_lambda, rebind_rounds=ct_rebinds, max_outer=ct_outer,
                max_inner=cfg.lm_max_inner_iterations, trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor, active=active,
                ct_linearize_fn=ct_lin, ct_error_fn=ct_err)
        return rot, ct_res.trans, rot_res, ct_res

    all_on = torch.ones(bsz, dtype=torch.bool, device=dev)
    rot, t, rot_res, ct_res = one_round(eye, init_translation, all_on)
    prev_t = init_translation
    for _ in range(max(int(cfg.alt_rounds), 1) - 1):
        # The reference's runtime lax.cond: re-solve only the instances whose
        # round moved the estimate far (cold starts), keep the rest. The
        # estimate comes out of the objective's reductions, so under
        # all-reducing hooks every rank takes this branch alike.
        moved = torch.linalg.vector_norm(t - prev_t, dim=-1)
        need = moved > torch.clamp(0.25 * torch.linalg.vector_norm(t, dim=-1), min=0.15)
        prev_t = t
        if profiling.host_read(need.any()):
            r2, t2, rr2, ct2 = one_round(rot, t, need)
            rot, t = lm.select(need, r2, rot), lm.select(need, t2, t)
            rot_res, ct_res = lm.select(need, rr2, rot_res), lm.select(need, ct2, ct_res)

    if cfg.ct_fine_resolution > 0:
        with profiling.span("frontend.fine", sync=lambda: ct_res.trans):
            vmap_fine = build_voxel_map(tgt_xyz, tgt_cov, tgt_mask, voxel_capacity,
                                        polar_res=None, resolution=cfg.ct_fine_resolution)
            ctx_f = gicp.make_context(_rotate(src_xyz, rot), src_mask,
                                      sym3.congruence(rot, src_cov), vmap_fine, polar_res=None,
                                      resolution=cfg.ct_fine_resolution,
                                      neighbor_search=cfg.ct_fine_neighbors)
            ct_res = lm.lm_translation_rebind(
                ctx_f, eye, t, zero3, last_translation, interval_tn, interval_tn_1,
                cfg.ct_lambda, rebind_rounds=ct_rebinds, max_outer=ct_outer,
                max_inner=cfg.lm_max_inner_iterations, trans_eps=cfg.transformation_epsilon,
                init_lambda_factor=cfg.lm_init_lambda_factor, ct_linearize_fn=ct_lin,
                ct_error_fn=ct_err)
        t = ct_res.trans

    return ScanPairResult(rot=rot, trans=t, rot_error=rot_res.error, ct_error=ct_res.error,
                          rot_iterations=rot_res.iterations, ct_iterations=ct_res.iterations,
                          converged=rot_res.converged & ct_res.converged)


def register_scan_pair(src_xyz, src_mask, tgt_xyz, tgt_mask, init_translation,
                       last_translation, interval_tn, interval_tn_1,
                       cfg: RegistrationConfig = RegistrationConfig(),
                       voxel_capacity: int = 8192, k: int = 20) -> ScanPairResult:
    """Register B raw source feature clouds [B, N, 3] against their targets
    (rotgicp.py:190-213); returned (rot, trans) is the total step."""
    src_cov = estimate_cov6(src_xyz, src_mask, k=k, method=cfg.regularization)
    tgt_cov = estimate_cov6(tgt_xyz, tgt_mask, k=k, method=cfg.regularization)
    return register_features(src_xyz, src_mask, src_cov, tgt_xyz, tgt_mask, tgt_cov,
                             init_translation, last_translation, interval_tn, interval_tn_1,
                             cfg, voxel_capacity)


def register_se3(src_xyz, src_mask, tgt_xyz, tgt_mask, init_rot, init_trans,
                 cfg: RegistrationConfig = RegistrationConfig(), voxel_capacity: int = 8192,
                 k: int = 20) -> lm.LMResult:
    """Full SE(3) VGICP alignment of B pairs (rotgicp.py:216-256): source
    [B, N, 3] onto target [B, M, 3] from (init_rot [B, 3, 3], init_trans
    [B, 3]), covariances by K2 and the target map by K1, then SE(3) LM.
    Returns tgt ~ rot @ src + trans."""
    src_cov = estimate_cov6(src_xyz, src_mask, k=k, method=cfg.regularization)
    tgt_cov = estimate_cov6(tgt_xyz, tgt_mask, k=k, method=cfg.regularization)
    polar_res = tuple(cfg.polar_resolution) if cfg.voxel_type == "polar" else None
    vmap = build_voxel_map(tgt_xyz, tgt_cov, tgt_mask, voxel_capacity, polar_res=polar_res,
                           resolution=cfg.voxel_resolution)
    ctx = gicp.make_context(src_xyz, src_mask, src_cov, vmap, polar_res=polar_res,
                            resolution=cfg.voxel_resolution, neighbor_search=cfg.neighbor_search)
    return lm.lm_register_se3(ctx, init_rot, init_trans, max_outer=cfg.max_outer_iterations,
                              max_inner=cfg.lm_max_inner_iterations, rot_eps=cfg.rotation_epsilon,
                              trans_eps=cfg.transformation_epsilon,
                              init_lambda_factor=cfg.lm_init_lambda_factor)

"""Experimental multi-neighbour GICP (point cloud to point cloud, k target
neighbours per source point), torch port of
`rolo_tpu/registration/experimental.py` (the reference's unbuilt
FastGICPMultiPoints).

Each source point is matched to its k nearest target points, and every
(point, neighbour) pair is a Mahalanobis-weighted residual. The pairs fill
the Correspondences layout [B, O = k, ., N] that the rot-GICP linearizers
read, so the SE(3) LM of registration/lm.py runs on them unchanged, batched
over a leading [B] like the other LM solvers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import sym3
from ..voxel.knn import estimate_cov6, knn_indices
from . import gicp
from . import lm as _lm
from .gicp import Correspondences, GICPContext
from .lm import LMResult


class MultiPointProblem(NamedTuple):
    """Padded source / target clouds with per-point covariances (sym3 SoA)."""

    src_xyz: torch.Tensor  # [B, N, 3]
    src_mask: torch.Tensor  # [B, N]
    src_cov6: torch.Tensor  # [B, 6, N]
    tgt_xyz: torch.Tensor  # [B, M, 3]
    tgt_mask: torch.Tensor  # [B, M]
    tgt_cov6: torch.Tensor  # [B, 6, M]


def make_problem(src_xyz, src_mask, tgt_xyz, tgt_mask, k_cov: int = 20,
                 method: str = "plane") -> MultiPointProblem:
    """Both clouds' covariances (kernel K2 on the card)."""
    return MultiPointProblem(src_xyz, src_mask, estimate_cov6(src_xyz, src_mask, k=k_cov,
                                                              method=method),
                             tgt_xyz, tgt_mask, estimate_cov6(tgt_xyz, tgt_mask, k=k_cov,
                                                              method=method))


def _bind_multipoint(prob: MultiPointProblem, rot, trans, k: int,
                     max_dist: float) -> Correspondences:
    """k-NN correspondences of the transformed source against the target
    points (experimental.py:64-93): weight 1/k per neighbour, neighbours
    beyond `max_dist` masked out."""
    b, n, _ = prob.src_xyz.shape
    p = prob.src_xyz @ rot.transpose(1, 2) + trans[:, None, :]  # [B, N, 3]
    idx = knn_indices(p, prob.src_mask, prob.tgt_xyz, prob.tgt_mask, k)  # [B, N, k]
    flat = idx.reshape(b, n * k)
    neigh = torch.gather(prob.tgt_xyz, 1, flat[..., None].expand(b, n * k, 3)).reshape(b, n, k, 3)
    d2 = torch.sum((neigh - p[:, :, None, :]) ** 2, dim=-1)  # [B, N, k]
    ok = (prob.src_mask[:, :, None] & torch.gather(prob.tgt_mask, 1, flat).reshape(b, n, k)
          & (d2 <= max_dist * max_dist))
    mean_b = neigh.permute(0, 2, 3, 1)  # [B, k, 3, N]
    cov_b6 = torch.gather(prob.tgt_cov6, 2, flat[:, None, :].expand(b, 6, n * k))
    cov_b6 = cov_b6.reshape(b, 6, n, k).permute(0, 3, 1, 2)  # [B, k, 6, N]
    rca = sym3.congruence(rot, prob.src_cov6)  # [B, 6, N]
    maha = sym3.inv(cov_b6 + rca[:, None])
    ok_t = ok.transpose(1, 2)  # [B, k, N]
    weight = torch.where(ok_t, 1.0 / float(k), 0.0)
    return Correspondences(weight, mean_b, torch.where(ok_t[:, :, None, :], maha, 0.0))


def register_multipoint(prob: MultiPointProblem, init_rot, init_trans, k: int = 8,
                        max_dist: float = 2.0, max_outer: int = _lm.MAX_OUTER,
                        max_inner: int = _lm.MAX_INNER, rot_eps: float = _lm.ROTATION_EPS,
                        trans_eps: float = _lm.TRANSFORM_EPS,
                        init_lambda_factor: float = _lm.INIT_LAMBDA_FACTOR) -> LMResult:
    """SE(3) LM over the multi-neighbour objective (experimental.py:96-157),
    re-binding the neighbours at every outer linearization. init_rot
    [B, 3, 3], init_trans [B, 3]."""
    # the context feeds only the source points and mask into the linearizers
    ctx = GICPContext(prob.src_xyz.transpose(1, 2), prob.src_mask, prob.src_cov6, None, None,
                      1.0, ((0, 0, 0),))
    return _lm._lm_register(
        lambda rot, trans: _bind_multipoint(prob, rot, trans, k, max_dist),
        lambda corr, rot, trans: gicp.se3_linearize(ctx, corr, rot, trans),
        lambda corr, rot, trans: gicp.compute_error(ctx, corr, rot, trans),
        _lm._se3_retract, _lm._se3_small(rot_eps, trans_eps), _lm._se3_delta0(init_rot),
        init_rot, init_trans, 6, max_outer, max_inner, init_lambda_factor, None)

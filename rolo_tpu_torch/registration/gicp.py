"""rot-GICP objective, torch port of `rolo_tpu/registration/gicp.py`.

Batched SoA throughout: source points [B, 3, N], covariances [B, 6, N],
correspondence planes [B, O, ., N] for O neighbour offsets. Conventions
follow the reference exactly:
  - residual e = voxel_mean_B - (R p_A + t)
  - weight w = sqrt(voxel point count)
  - Mahalanobis M = (cov_B + R cov_A R^T)^{-1}
  - SO(3) Jacobian J = skew(R p_A + t); SE(3) J = [skew(R p_A + t) | -I]
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import sym3
from ..ops.voxel_join import pack_polar, pack_uniform
from ..voxel.voxelmap import VoxelMap, lookup_join, polar_bins, uniform_bins

OFFSETS = {
    "direct1": [(0, 0, 0)],
    "direct7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    "direct27": [(i - 1, j - 1, k - 1) for i in range(3) for j in range(3) for k in range(3)],
}
_IDX6 = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


class GICPContext(NamedTuple):
    """Batched registration problems: source clouds + target voxel maps."""

    src_t: torch.Tensor  # [B, 3, N]
    src_mask: torch.Tensor  # [B, N]
    src_cov6: torch.Tensor  # [B, 6, N]
    vmap: VoxelMap
    polar_res: Optional[Sequence[float]]
    resolution: float
    offsets: Tuple[Tuple[int, int, int], ...]


class Correspondences(NamedTuple):
    weight: torch.Tensor  # [B, O, N]
    mean_b: torch.Tensor  # [B, O, 3, N]
    maha: torch.Tensor  # [B, O, 6, N]


def make_context(src_xyz, src_mask, src_cov6, vmap, polar_res=None, resolution=1.0,
                 neighbor_search="direct1") -> GICPContext:
    """src_xyz [B, N, 3] (converted to SoA); src_cov6 [B, 6, N]."""
    return GICPContext(src_xyz.transpose(1, 2), src_mask, src_cov6, vmap,
                       tuple(polar_res) if polar_res is not None else None, resolution,
                       tuple(OFFSETS[neighbor_search]))


def _transform(ctx: GICPContext, rot, trans) -> torch.Tensor:
    return rot @ ctx.src_t + trans[:, :, None]


def update_correspondences(ctx: GICPContext, rot, trans) -> Correspondences:
    """Bin transformed source points into the target maps and precompute the
    Mahalanobis planes (gicp.py:92-125)."""
    p = _transform(ctx, rot, trans)
    b, _, n = p.shape
    if ctx.polar_res is not None:
        b0, b1, b2 = polar_bins(p[:, 0], p[:, 1], p[:, 2], ctx.polar_res)
    else:
        b0, b1, b2 = uniform_bins(p[:, 0], p[:, 1], p[:, 2], ctx.resolution)
    packs = []
    for (o0, o1, o2) in ctx.offsets:
        coord = torch.stack([b0 + o0, b1 + o1, b2 + o2], dim=-1)
        packs.append(pack_polar(coord) if ctx.polar_res is not None else pack_uniform(coord))
    o = len(packs)
    pack = torch.stack(packs, dim=1)  # [B, O, N]
    found, num, mean_b, cov_b6 = lookup_join(ctx.vmap, pack.reshape(b, o * n))
    found = found.reshape(b, o, n) & ctx.src_mask[:, None, :]
    num = num.reshape(b, o, n)
    mean_b = mean_b.reshape(b, 3, o, n).transpose(1, 2)
    cov_b6 = cov_b6.reshape(b, 6, o, n).transpose(1, 2)
    rca = sym3.congruence(rot, ctx.src_cov6)  # [B, 6, N]
    maha = sym3.inv(cov_b6 + rca[:, None])
    weight = torch.where(found, torch.sqrt(torch.clamp(num, min=0.0)), 0.0)
    return Correspondences(weight, mean_b, torch.where(found[:, :, None, :], maha, 0.0))


def _skew_cols(p: torch.Tensor):
    """Columns of skew(p) for p [B, 3, N]."""
    zero = torch.zeros_like(p[:, 0])
    c0 = torch.stack([zero, p[:, 2], -p[:, 1]], dim=1)
    c1 = torch.stack([-p[:, 2], zero, p[:, 0]], dim=1)
    c2 = torch.stack([p[:, 1], -p[:, 0], zero], dim=1)
    return c0, c1, c2


def _dot3(a, b):
    return torch.sum(a * b, dim=-2)


def _wsum(w, x):
    """Per-instance sum of w * x over (offset, point): [B, O, N] -> [B]."""
    return torch.sum(w * x, dim=(-2, -1))


def compute_error(ctx: GICPContext, corr: Correspondences, rot, trans) -> torch.Tensor:
    """sum_i w_i e_i^T M_i e_i per instance -> [B]."""
    p = _transform(ctx, rot, trans)
    e = corr.mean_b - p[:, None]
    return _wsum(corr.weight, sym3.quad(corr.maha, e))


def so3_linearize(ctx: GICPContext, corr: Correspondences, rot, trans):
    """(error [B], H [B, 3, 3], b [B, 3]) for the rotation-only step."""
    p = _transform(ctx, rot, trans)
    e = corr.mean_b - p[:, None]
    me = sym3.matvec(corr.maha, e)
    err = _wsum(corr.weight, _dot3(e, me))
    cols = _skew_cols(p)
    mc = [sym3.matvec(corr.maha, c[:, None]) for c in cols]
    w = corr.weight
    h = torch.stack(
        [torch.stack([_wsum(w, _dot3(cols[i][:, None], mc[j])) for j in range(3)], -1)
         for i in range(3)], -2)
    bvec = torch.stack([_wsum(w, _dot3(cols[i][:, None], me)) for i in range(3)], -1)
    return err, h, bvec


def _se3_hb(w, maha, p, me):
    """[skew(p) | -I] Hessian [B, 6, 6] and gradient [B, 6] (gicp.py:196-218)."""
    cols = _skew_cols(p)
    mc = [sym3.matvec(maha, c[:, None]) for c in cols]
    h_rr = [[_wsum(w, _dot3(cols[i][:, None], mc[j])) for j in range(3)] for i in range(3)]
    h_rt = [[-_wsum(w, mc[i][:, :, j, :]) for j in range(3)] for i in range(3)]
    h_tt = [[_wsum(w, maha[:, :, _IDX6[i][j], :]) for j in range(3)] for i in range(3)]
    top = torch.stack([torch.stack(h_rr[i] + h_rt[i], -1) for i in range(3)], -2)
    bot = torch.stack([torch.stack([h_rt[j][i] for j in range(3)] + h_tt[i], -1)
                       for i in range(3)], -2)
    h = torch.cat([top, bot], dim=-2)
    b_r = [_wsum(w, _dot3(cols[i][:, None], me)) for i in range(3)]
    b_t = [-_wsum(w, me[:, :, i, :]) for i in range(3)]
    return h, torch.stack(b_r + b_t, -1)


def _ct_terms(ctx, corr, t, init_guess, last_t0, interval_tn, interval_tn_1, ct_lambda):
    q = ctx.src_t + t[:, :, None]
    e = corr.mean_b - q[:, None]
    ct = (init_guess + t) / interval_tn[:, None] - last_t0 / interval_tn_1[:, None]  # [B, 3]
    n_corr = torch.clamp((corr.weight > 0).sum(dim=(-2, -1)).to(t.dtype), min=1.0)
    lam = ct_lambda / n_corr  # [B]
    ct_b = ct[:, None, :, None].expand_as(corr.mean_b)
    return q, e, ct_b, lam


def ct_linearize(ctx: GICPContext, corr: Correspondences, t, init_guess, last_t0,
                 interval_tn, interval_tn_1, ct_lambda: float):
    """Continuous-time translation linearization with the corrected
    velocity-continuity sign (gicp.py:221-289): error [B], H [B, 6, 6],
    b [B, 6]. interval_* are [B]."""
    q, e, ct_b, lam = _ct_terms(ctx, corr, t, init_guess, last_t0, interval_tn,
                                interval_tn_1, ct_lambda)
    w = corr.weight
    me = sym3.matvec(corr.maha, e)
    mct = sym3.matvec(corr.maha, ct_b)
    err = _wsum(w, _dot3(e, me)) + lam * _wsum(w, _dot3(ct_b, mct))
    h1, b1 = _se3_hb(w, corr.maha, q, me)
    m_sum = torch.stack(
        [torch.stack([_wsum(w, corr.maha[:, :, _IDX6[i][j], :]) for j in range(3)], -1)
         for i in range(3)], -2)
    dt = interval_tn[:, None, None]
    h2 = torch.zeros_like(h1)
    h2[:, 3:, 3:] = m_sum / (dt * dt)
    b2 = torch.zeros_like(b1)
    b2[:, 3:] = torch.stack([_wsum(w, mct[:, :, i, :]) for i in range(3)], -1) / dt[:, :, 0]
    return err, h1 + lam[:, None, None] * h2, b1 + lam[:, None] * b2


def ct_error(ctx: GICPContext, corr: Correspondences, t, init_guess, last_t0, interval_tn,
             interval_tn_1, ct_lambda: float) -> torch.Tensor:
    """compute_t_error with the corrected sign (gicp.py:292-316) -> [B]."""
    _, e, ct_b, lam = _ct_terms(ctx, corr, t, init_guess, last_t0, interval_tn, interval_tn_1,
                                ct_lambda)
    return _wsum(corr.weight, sym3.quad(corr.maha, e)) + lam * _wsum(
        corr.weight, sym3.quad(corr.maha, ct_b))

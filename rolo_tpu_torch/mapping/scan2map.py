"""Scan-to-submap Gauss-Newton alignment with LOAM point-to-line and
point-to-plane factors and the degeneracy projection, torch port of
`rolo_tpu/mapping/scan2map.py` (backMapping's scan2MapOptimization).

The k-NN searches are `knn_indices` in the matmul form over [chunk, N]
distance tiles with `torch.topk`. The reference's `lax.while_loop` is a
Python loop with one host check per iteration; its inner `lax.cond`s
(stale-candidate guard, rebind, first-iteration projection) are host
branches on the iteration count or on the value fetched by that same check.

Every function takes an optional leading batch: `scan2map_optimize` over B
scans and submaps is the reference under `vmap`, each instance with its own
convergence and stale-candidate masks, and an instance that has stopped
keeps its pose. An instance of a batch gets the bits it gets alone: the
small products are `small_matmul`, the normal equations two-stage
`fixed_sum`s, and the plane and line fits' products, the k-NN tiles and the
degeneracy eigendecomposition one call per instance (`ops.linalg.each`),
whose rounding the fits' gates are sensitive to.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import so3
from ..ops.eig3 import eigh3
from ..ops.linalg import each, fixed_sum, matmul_each, small_matmul, solve_psd
from ..pointcloud.cloud import PaddedCloud
from ..runtime import profiling
from ..voxel.knn import knn_indices


class FactorSet(NamedTuple):
    """Per-point linearized constraints: direction [..., N, 3], residual
    [..., N], point (sensor frame) [..., N, 3], valid [..., N]."""

    direction: torch.Tensor
    residual: torch.Tensor
    point: torch.Tensor
    valid: torch.Tensor


def _rpy_jacobian(rpy: torch.Tensor) -> torch.Tensor:
    """dR [3, 3, 3] with dR[i, j, k] = dR[i, j] / drpy[k] for R = Rz Ry Rx
    (the reference takes jax.jacfwd of rpy_to_matrix): dR/droll = R [e_x]x,
    dR/dpitch = Rz Ry [e_y]x Rx, dR/dyaw = [e_z]x R."""
    zero = torch.zeros_like(rpy[..., 0])
    rx = so3.rpy_to_matrix(rpy[..., 0], zero, zero)
    ry = so3.rpy_to_matrix(zero, rpy[..., 1], zero)
    rz = so3.rpy_to_matrix(zero, zero, rpy[..., 2])
    e = so3.skew(torch.eye(3, dtype=rpy.dtype, device=rpy.device))  # e[k] = [e_k]x
    rzy = small_matmul(rz, ry)
    r = small_matmul(rzy, rx)
    return torch.stack([small_matmul(r, e[0]), small_matmul(small_matmul(rzy, e[1]), rx),
                        small_matmul(e[2], r)], dim=-1)


def _rpy_matrix(rpy: torch.Tensor) -> torch.Tensor:
    return so3.rpy_to_matrix(rpy[..., 0], rpy[..., 1], rpy[..., 2])


def _world(rot: torch.Tensor, trans: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return small_matmul(pts, rot.transpose(-1, -2)) + trans[..., None, :]


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for the per-point matrices [..., N, m, k] of the plane and line
    fits, one matmul per instance of a batch."""
    return a @ b if a.dim() == 3 else matmul_each(a, b)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [..., M, C] at the indices idx [..., *rest] (per instance) ->
    [..., *rest, C]."""
    flat = idx.reshape(*src.shape[:-2], -1)
    out = torch.gather(src, -2, flat[..., None].expand(*flat.shape, src.shape[-1]))
    return out.reshape(*idx.shape, src.shape[-1])


class CornerBindings(NamedTuple):
    """Frozen point-to-line correspondences: line center, direction, valid."""

    center: torch.Tensor  # [N, 3]
    u: torch.Tensor  # [N, 3]
    valid: torch.Tensor  # [N]


class SurfBindings(NamedTuple):
    """Frozen point-to-plane correspondences: unit normal + offset."""

    pa: torch.Tensor  # [N, 3]
    pd: torch.Tensor  # [N]
    valid: torch.Tensor  # [N]


def nn_candidates(pts, mask, submap: PaddedCloud, rot, trans, n_cand: int, chunk: int = 512,
                  approx_knn: bool = False):
    """The n_cand nearest submap points per point at this pose, and the
    median distance to the farthest of them over valid points
    (scan2map.py:73-100). The median interpolates between the two middle
    values, as `jnp.nanmedian` does (`torch.nanmedian` would take the lower);
    with no valid point it is 1.0."""
    world = _world(rot, trans, pts)
    idx = knn_indices(world, mask, submap.xyz, submap.mask, n_cand, chunk, approximate=approx_knn)
    far = _take(submap.xyz, idx[..., -1])
    d = torch.linalg.vector_norm(far - world, dim=-1)
    d = torch.where(mask & _take(submap.mask[..., None], idx[..., -1])[..., 0], d, float("nan"))
    radius = torch.nan_to_num(torch.nanquantile(d, 0.5, dim=-1), nan=1.0)
    return idx, radius


def _top5_from_candidates(world, cand_idx, submap: PaddedCloud):
    """Exact 5-NN among the candidate set [..., N, C]."""
    cand = _take(submap.xyz, cand_idx)
    d2 = torch.sum((cand - world[..., None, :]) ** 2, dim=-1)
    d2 = torch.where(_take(submap.mask[..., None], cand_idx)[..., 0], d2, float("inf"))
    sel = torch.topk(d2, 5, dim=-1, largest=False).indices
    return torch.gather(cand_idx, -1, sel)


def _neighbors(pts, mask, submap, rot, trans, chunk, approx_knn, cand_idx):
    world = _world(rot, trans, pts)
    if cand_idx is not None:
        idx = _top5_from_candidates(world, cand_idx, submap)
    else:
        idx = knn_indices(world, mask, submap.xyz, submap.mask, 5, chunk, approximate=approx_knn)
    neigh = _take(submap.xyz, idx)  # [..., N, 5, 3]
    near_ok = torch.amax(torch.sum((neigh - world[..., None, :]) ** 2, dim=-1), dim=-1) < 1.0
    return neigh, near_ok


def corner_bind(pts, mask, submap: PaddedCloud, rot, trans, chunk: int = 512,
                approx_knn: bool = False, cand_idx: Optional[torch.Tensor] = None
                ) -> CornerBindings:
    """5-NN + PCA line fit (scan2map.py:114-143)."""
    neigh, near_ok = _neighbors(pts, mask, submap, rot, trans, chunk, approx_knn, cand_idx)
    center = neigh.mean(dim=-2)
    centered = neigh - center[..., None, :]
    cov = _bmm(centered.transpose(-1, -2), centered) / 5.0
    eigval, eigvec = eigh3(cov)
    line_ok = eigval[..., 2] > 3.0 * eigval[..., 1]
    return CornerBindings(center, eigvec[..., 2], mask & near_ok & line_ok)


def corner_eval(b: CornerBindings, pts, rot, trans) -> FactorSet:
    """Point-to-line residual and direction at the current pose."""
    rel = _world(rot, trans, pts) - b.center
    along = torch.sum(rel * b.u, dim=-1)
    perp = rel - along[..., None] * b.u
    ld2 = torch.linalg.vector_norm(perp, dim=-1)
    direction = perp / torch.clamp(ld2, min=1e-9)[..., None]
    s = 1.0 - 0.9 * torch.abs(ld2)
    return FactorSet(s[..., None] * direction, s * ld2, pts, b.valid & (s > 0.1))


def surf_bind(pts, mask, submap: PaddedCloud, rot, trans, chunk: int = 512,
              approx_knn: bool = False, cand_idx: Optional[torch.Tensor] = None) -> SurfBindings:
    """5-NN + least-squares plane fit A n = -1 (scan2map.py:162-196)."""
    neigh, near_ok = _neighbors(pts, mask, submap, rot, trans, chunk, approx_knn, cand_idx)
    n_vec = solve_psd(_bmm(neigh.transpose(-1, -2), neigh), -neigh.sum(dim=-2))
    norm = torch.linalg.vector_norm(n_vec, dim=-1)
    pa = n_vec / torch.clamp(norm, min=1e-9)[..., None]
    pd = 1.0 / torch.clamp(norm, min=1e-9)
    plane_err = torch.abs(_bmm(neigh, pa[..., None])[..., 0] + pd[..., None])
    plane_ok = torch.amax(plane_err, dim=-1) <= 0.2
    return SurfBindings(pa, pd, mask & near_ok & plane_ok)


def surf_eval(b: SurfBindings, pts, rot, trans) -> FactorSet:
    pd2 = torch.sum(_world(rot, trans, pts) * b.pa, dim=-1) + b.pd
    origin_range = torch.linalg.vector_norm(pts, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.sqrt(torch.clamp(origin_range, min=1e-6)))
    return FactorSet(s[..., None] * b.pa, s * pd2, pts, b.valid & (s > 0.1))


def corner_factors(pts, mask, submap, rot, trans, chunk: int = 512) -> FactorSet:
    """Bind and evaluate at one pose (the reference's per-iteration step)."""
    return corner_eval(corner_bind(pts, mask, submap, rot, trans, chunk), pts, rot, trans)


def surf_factors(pts, mask, submap, rot, trans, chunk: int = 512) -> FactorSet:
    return surf_eval(surf_bind(pts, mask, submap, rot, trans, chunk), pts, rot, trans)


class Scan2MapResult(NamedTuple):
    rot: torch.Tensor
    trans: torch.Tensor
    rpy: torch.Tensor
    degenerate: torch.Tensor
    iterations: torch.Tensor
    num_factors: torch.Tensor
    converged: torch.Tensor


def _gn_normal_eqs(f: FactorSet, dr: torch.Tensor):
    """AtA [..., 6, 6] and AtB [..., 6] over valid factors, columns [roll,
    pitch, yaw, x, y, z] (scan2map.py:245-258), each entry summed over the
    points by `fixed_sum`."""
    # jrot[n, k] = sum_ij direction[n, i] dR[i, j, k] point[n, j]
    dr_p = small_matmul(f.point[..., None, None, :], dr.unsqueeze(-4))[..., 0, :]
    jrot = small_matmul(f.direction[..., None, :], dr_p)[..., 0, :]
    jac = torch.cat([jrot, f.direction], dim=-1)
    wj = jac * f.valid[..., None].to(jac.dtype)
    terms = torch.cat([(wj[..., :, None] * jac[..., None, :]).flatten(-2),
                       wj * -f.residual[..., None]], dim=-1)  # [..., N, 42]
    sums = fixed_sum(terms.transpose(-1, -2))
    return sums[..., :36].reshape(*sums.shape[:-1], 6, 6), sums[..., 36:]


def scan2map_optimize(rpy0: torch.Tensor, xyz0: torch.Tensor, corner_pts, corner_mask, surf_pts,
                      surf_mask, submap_corner: PaddedCloud, submap_surf: PaddedCloud,
                      max_iterations: int = 30, degeneracy_threshold: float = 100.0,
                      min_factors: int = 50, chunk: int = 512, rebind_every: int = 5,
                      approx_knn: bool = False, n_candidates: int = 16) -> Scan2MapResult:
    """Iterative GN scan-to-submap alignment (scan2map.py:261-406).
    rpy0 / xyz0: the initial guess. With n_candidates > 5 the full-submap
    search runs at the initial pose with that many neighbours, every
    iteration re-ranks the candidates, and the search is re-run when the pose
    has moved more than half the candidate radius since it was bound (30 m
    turns the angle change into a displacement; the angles wrap per axis).
    Without candidates the full 5-NN is re-searched every `rebind_every`
    iterations.

    rpy0 / xyz0 [3] with [N, 3] clouds and submaps, or [B, 3] with [B, N, 3]
    ones: B problems at once, each stopping on its own (the result's fields
    then lead with [B]). The loop runs while any instance is active, with
    one host read per iteration; a stale candidate set is searched again
    for every instance when any needs it, and kept where it was not
    stale."""
    if rpy0.dim() == 1:
        res = scan2map_optimize(
            rpy0[None], xyz0[None], corner_pts[None], corner_mask[None], surf_pts[None],
            surf_mask[None], PaddedCloud(submap_corner.xyz[None], submap_corner.mask[None]),
            PaddedCloud(submap_surf.xyz[None], submap_surf.mask[None]), max_iterations,
            degeneracy_threshold, min_factors, chunk, rebind_every, approx_knn, n_candidates)
        return Scan2MapResult(*(t[0] for t in res))
    dt, dev, bsz = xyz0.dtype, xyz0.device, xyz0.shape[0]
    use_cand = bool(n_candidates) and n_candidates > 5

    def full_cand(rpy, xyz):
        rot = _rpy_matrix(rpy)
        cand_c, rad_c = nn_candidates(corner_pts, corner_mask, submap_corner, rot, xyz,
                                      n_candidates, chunk, approx_knn)
        cand_s, rad_s = nn_candidates(surf_pts, surf_mask, submap_surf, rot, xyz,
                                      n_candidates, chunk, approx_knn)
        return cand_c, cand_s, torch.minimum(rad_c, rad_s), rpy, xyz

    def rebind(rpy, xyz, cand):
        rot = _rpy_matrix(rpy)
        cand_c, cand_s = (cand[0], cand[1]) if cand is not None else (None, None)
        return (corner_bind(corner_pts, corner_mask, submap_corner, rot, xyz, chunk, approx_knn,
                            cand_c),
                surf_bind(surf_pts, surf_mask, submap_surf, rot, xyz, chunk, approx_knn, cand_s))

    def moved_far(rpy, xyz, cand) -> torch.Tensor:
        _, _, radius, a_rpy, a_xyz = cand
        drpy = rpy - a_rpy
        drpy = torch.atan2(torch.sin(drpy), torch.cos(drpy))
        moved = (torch.linalg.vector_norm(xyz - a_xyz, dim=-1)
                 + 30.0 * torch.linalg.vector_norm(drpy, dim=-1))
        return moved > 0.5 * radius

    def per_instance(flag, t):
        return flag.reshape(-1, *(1,) * (t.dim() - 1))

    cand = full_cand(rpy0, xyz0) if use_cand else None
    cb, sb = rebind(rpy0, xyz0, cand)
    rpy, xyz = rpy0, xyz0
    proj = degen = None
    nfac = torch.zeros(bsz, dtype=torch.int32, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int32, device=dev)
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    active = torch.ones(bsz, dtype=torch.bool, device=dev)
    stale = None  # instances whose candidates the guard found stale, when any
    it = 0
    while it < max_iterations:
        if stale is not None:
            cand = tuple(torch.where(per_instance(stale, old), new, old)
                         for new, old in zip(full_cand(rpy, xyz), cand))
        rebound_now = it > 0 and (use_cand or it % rebind_every == 0)
        if rebound_now:
            cb, sb = rebind(rpy, xyz, cand)
        fresh = rebound_now or it == 0
        rot = _rpy_matrix(rpy)
        dr = _rpy_jacobian(rpy)
        cf = corner_eval(cb, corner_pts, rot, xyz)
        sf = surf_eval(sb, surf_pts, rot, xyz)
        nfac_it = (cf.valid.sum(dim=-1) + sf.valid.sum(dim=-1)).to(torch.int32)
        ata_c, atb_c = _gn_normal_eqs(cf, dr)
        ata_s, atb_s = _gn_normal_eqs(sf, dr)
        ata = ata_c + ata_s
        x = solve_psd(ata, atb_c + atb_s)
        if it == 0:  # degeneracy projection from the first linearization
            e, v = each(torch.linalg.eigh, ata)
            keep = (e >= degeneracy_threshold).to(dt)
            proj = small_matmul(v * keep[..., None, :], v.transpose(-1, -2))
            degen = torch.any(e < degeneracy_threshold, dim=-1)
        x = small_matmul(proj, x[..., None])[..., 0]
        enough = nfac_it >= min_factors
        x = torch.where(enough[:, None], x, 0.0)
        delta_r = torch.rad2deg(torch.linalg.vector_norm(x[:, :3], dim=-1))
        delta_t = 100.0 * torch.linalg.vector_norm(x[:, 3:], dim=-1)
        conv_it = ((delta_r < 0.05) & (delta_t < 0.05) & fresh) | ~enough
        rpy = torch.where(active[:, None], rpy + x[:, :3], rpy)
        xyz = torch.where(active[:, None], xyz + x[:, 3:], xyz)
        nfac = torch.where(active, nfac_it, nfac)
        conv = torch.where(active, conv_it, conv)
        iters = iters + active.to(torch.int32)
        active = active & ~conv_it
        it += 1
        if it >= max_iterations:
            break
        if use_cand:
            stale = moved_far(rpy, xyz, cand) & active
            flags = profiling.host_read(torch.cat([active.any()[None], stale]),
                                        torch.Tensor.tolist)
            if not flags[0]:
                break
            stale = stale if any(flags[1:]) else None
        elif not profiling.host_read(active.any()):
            break
    return Scan2MapResult(_rpy_matrix(rpy), xyz, rpy, degen, iters, nfac, conv)


def constrain_transform(rpy: torch.Tensor, xyz: torch.Tensor, rotation_tolerance: float,
                        z_tolerance: float):
    """transformUpdate: clamp roll, pitch and z (scan2map.py:409-416)."""
    rpy = torch.cat([torch.clamp(rpy[..., :2], -rotation_tolerance, rotation_tolerance),
                     rpy[..., 2:]], dim=-1)
    xyz = torch.cat([xyz[..., :2], torch.clamp(xyz[..., 2:], -z_tolerance, z_tolerance)], dim=-1)
    return rpy, xyz

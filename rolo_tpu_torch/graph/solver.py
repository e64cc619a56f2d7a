"""Batched pose-graph Gauss-Newton, torch port of `rolo_tpu/graph/solver.py`.

Every solve is a full Gauss-Newton relinearization over all poses (the
iSAM2 replacement): between-factor residuals e = Log(Z^{-1} T_i^{-1} T_j)
in (w, t) order, exact per-factor 6x6 Jacobians at zero right-perturbation
(closed form, where the reference takes `jax.jacrev`: autodiff through the
log map was ~110 ms of host-bound launches per linearization on the card),
and Cauchy IRLS weights on robust factors. Three linear solvers:

  "bcr"   block cyclic reduction on the odometry chain plus a Woodbury
          correction for the loop/prior factors (production, backend.py);
  "dense" the [6K, 6K] Hessian and one Cholesky;
  "pcg"   matrix-free preconditioned CG (the argument default), with the
          "chain" (exact block-tridiagonal chain solve) or "jacobi"
          preconditioner.

`lax.while_loop`s become Python loops with one host check per iteration.
The `.at[].add` scatter sums become fixed-order segment sums
(`ops/segment.py`) over factor ids sorted once per linearization, not float
`index_add_`, whose CUDA atomics sum in another order on every call: a solve
gives the same bits each time it runs.

A graph, its poses and its count may lead with [B]: B independent graphs
solved at once (every method; the reference under `vmap`), each with its
own Gauss-Newton stop, and with "pcg" its own CG stop. Instance b's poses
are segments b * K + i of one segment sum, the small products are
`small_matmul`, chi^2 and the CG dot products two-stage `fixed_sum`s, and
the Cholesky factorizations, the Woodbury system's large products and the
Jacobi preconditioner's inverse one call per instance: a batch gives each
graph the bits it gets alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3, so3
from ..geometry.se3 import SE3
from ..ops.linalg import (cholesky_solve_unrolled_mat, each, fixed_sum, inv_psd_unrolled,
                          small_matmul as mm)
from ..ops.pytree import tree_map
from ..ops.segment import Segments, segment_sum, segments
from ..runtime import profiling
from .factors import FIRST_PRIOR_VARIANCES, ODOM_VARIANCES, BetweenFactors, PoseGraph


def _between_residual(xi_i, xi_j, rot_i, trans_i, rot_j, trans_j, rel_rot, rel_trans):
    """e = Log(Z^{-1} (T_i Exp(xi_i))^{-1} (T_j Exp(xi_j))), [6] (w, t)."""
    pi = SE3(rot_i, trans_i).compose(se3.exp(xi_i))
    pj = SE3(rot_j, trans_j).compose(se3.exp(xi_j))
    err = SE3(rel_rot, rel_trans).inverse().compose(pi.inverse().compose(pj))
    return se3.log(err)


def _series(th2: torch.Tensor, coefs) -> torch.Tensor:
    out = torch.zeros_like(th2)
    for c in reversed(coefs):
        out = out * th2 + c
    return out


def _jr_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3) at xi = (w, rho) [..., 6] -> [..., 6, 6]
    for the rotation-first exp of geometry/se3.py: [[A, 0], [-A Q A, A]] with
    A the SO(3) inverse right Jacobian and Q = Q(-w, -rho) the translational
    block of the left Jacobian (Barfoot & Furgale 2014, eq. 102). Below
    theta = 0.5 the coefficients are their Taylor series (f32 cancels in the
    closed forms there)."""
    w, rho = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < 0.25
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    sin, cos = torch.sin(th), torch.cos(th)
    a2 = torch.where(small, _series(th2, [1 / 12, 1 / 720, 1 / 30240, 1 / 1209600]),
                     1.0 / th2 - (1.0 + cos) / (2.0 * th * sin))
    c1 = torch.where(small, _series(th2, [1 / 6, -1 / 120, 1 / 5040, -1 / 362880]),
                     (th - sin) / th ** 3)
    c2 = torch.where(small, _series(th2, [1 / 24, -1 / 720, 1 / 40320, -1 / 3628800]),
                     (0.5 * th2 + cos - 1.0) / th2 ** 2)
    c3 = torch.where(small, _series(th2, [1 / 120, -1 / 2520, 1 / 120960, -1 / 9979200]),
                     0.5 * (c2 + 3.0 * (th - sin - th ** 3 / 6.0) / th ** 5))
    wh = so3.skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    a = eye + 0.5 * wh + a2[..., None, None] * mm(wh, wh)
    # Barfoot's Q(phi, p) at phi = -w, p = -rho
    nw, npp = -wh, -so3.skew(rho)
    wp, pw = mm(nw, npp), mm(npp, nw)
    wpw = mm(wp, nw)
    q = (0.5 * npp + c1[..., None, None] * (wp + pw + wpw)
         + c2[..., None, None] * (mm(nw, wp) + mm(pw, nw) - 3.0 * wpw)
         + c3[..., None, None] * (mm(wpw, nw) + mm(nw, wpw)))
    out = xi.new_zeros(*xi.shape[:-1], 6, 6)
    out[..., :3, :3] = a
    out[..., 3:, 3:] = a
    out[..., 3:, :3] = -mm(mm(a, q), a)
    return out


def _res_and_jac(ri, ti, rj, tj, zr, zt):
    """Residuals [..., F, 6] and Jacobians ([..., F, 6, 6] twice) w.r.t.
    right perturbations xi_i, xi_j at zero. The reference takes `jax.jacrev`
    of the residual; here they are analytic: J_j = Jr^-1(e) and
    J_i = -Jr^-1(e) Ad(T_j^-1 T_i), Ad = [[R, 0], [t^ R, R]] in (w, t) order
    (tests/test_torch_graph.py holds them to torch.func.jacrev)."""
    pi, pj = SE3(ri, ti), SE3(rj, tj)
    res = se3.log(SE3(zr, zt).inverse().compose(pi.inverse().compose(pj)))
    jj = _jr_inv(res)
    rel = pj.inverse().compose(pi)
    ad = res.new_zeros(*res.shape[:-1], 6, 6)
    ad[..., :3, :3] = rel.rot
    ad[..., 3:, 3:] = rel.rot
    ad[..., 3:, :3] = mm(so3.skew(rel.trans), rel.rot)
    return res, -mm(jj, ad), jj


class FactorBlocks(NamedTuple):
    """Linearized factors: indices, Jacobians, whitening weights, residuals,
    each leading with the graphs' batch dims when there are any. Rows
    [0, K) are the odometry chain, row K the first-pose anchor, the rest the
    loop and prior factors (the layout `_chain_parts` relies on)."""

    i: torch.Tensor  # [..., F] int64
    j: torch.Tensor  # [..., F]
    jac_i: torch.Tensor  # [..., F, 6, 6]
    jac_j: torch.Tensor  # [..., F, 6, 6]
    info_w: torch.Tensor  # [..., F, 6] diagonal information (1/var * irls)
    res: torch.Tensor  # [..., F, 6]
    valid: torch.Tensor  # [..., F] bool
    # the poses of cat([i, j]) with instance b's as b * K + i, sorted once
    # per linearization
    pose_segs: Segments


def _take_pose(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., K, *rest] at per-instance pose indices idx [..., F]."""
    rest = x.shape[idx.dim():]
    index = idx.reshape(*idx.shape, *(1,) * len(rest)).expand(*idx.shape, *rest)
    return torch.gather(x, idx.dim() - 1, index)


def _each_on_cpu(fn, lead, *args):
    """fn(*args) for args leading with the graphs' batch dims `lead`; on the
    CPU one call per instance (`ops.linalg.each`). torch's CPU kernels take
    sin, cos and atan2 in SIMD lanes and a tensor's remainder in scalar code,
    which rounds otherwise, so there an element's bits would follow the
    batch's size; on the card every element takes the same code."""
    if not lead or args[0].device.type != "cpu":
        return fn(*args)
    out = each(fn, *(a.reshape(-1, *a.shape[len(lead):]) for a in args))
    return tree_map(lambda t: t.reshape(*lead, *t.shape[1:]), out)


def _instance_offsets(lead, size: int, device) -> torch.Tensor:
    """b * size for each instance b of the batch dims `lead`, shaped [*lead, 1]."""
    return (torch.arange(math.prod(lead), device=device) * size).reshape(*lead, 1)


def _linearize(graph: PoseGraph, rot, trans, count) -> FactorBlocks:
    """solver.py:65-116."""
    lead, k = rot.shape[:-3], rot.shape[-3]
    dtype, dev = trans.dtype, trans.device
    count = torch.as_tensor(count, device=dev)[..., None]
    idx = torch.arange(k, device=dev)
    odom_valid = (idx >= 1) & (idx < count)
    prev = torch.clamp(idx - 1, min=0)
    res_o, ji_o, jj_o = _each_on_cpu(_res_and_jac, lead, rot[..., prev, :, :],
                                     trans[..., prev, :], rot, trans, graph.odom_rel_rot,
                                     graph.odom_rel_trans)
    info_o = (1.0 / torch.tensor(ODOM_VARIANCES, dtype=dtype, device=dev)).expand(*lead, k, 6)

    # first-pose prior: a between factor from a fixed identity anchor
    res_p, _, jj_p = _each_on_cpu(_res_and_jac, lead,
                                  torch.eye(3, dtype=dtype, device=dev).expand(*lead, 1, 3, 3),
                                  trans.new_zeros(*lead, 1, 3), rot[..., :1, :, :],
                                  trans[..., :1, :], graph.first_rot[..., None, :, :],
                                  graph.first_trans[..., None, :])
    info_p = (1.0 / torch.tensor(FIRST_PRIOR_VARIANCES, dtype=dtype,
                                 device=dev)).expand(*lead, 1, 6)

    def between_blocks(f: BetweenFactors):
        fi, fj = f.i.long(), f.j.long()
        res_b, ji_b, jj_b = _each_on_cpu(_res_and_jac, lead, _take_pose(rot, fi),
                                         _take_pose(trans, fi), _take_pose(rot, fj),
                                         _take_pose(trans, fj), f.rel_rot, f.rel_trans)
        inv_var = 1.0 / f.noise_var
        r2 = torch.sum(res_b * res_b * inv_var, dim=-1)
        c2 = f.robust_c ** 2
        irls = torch.where(f.robust_c > 0, c2 / torch.clamp(c2 + r2, min=1e-12), 1.0)
        fvalid = f.valid & (f.i < count) & (f.j < count)
        return fi, fj, res_b, ji_b, jj_b, inv_var * irls[..., None], fvalid

    li, lj, res_l, ji_l, jj_l, info_l, valid_l = between_blocks(graph.loops)
    gi, gj, res_g, ji_g, jj_g, info_g, valid_g = between_blocks(graph.priors)
    zero1 = idx.new_zeros(*lead, 1)
    fi = torch.cat([prev.expand(*lead, k), zero1, li, gi], dim=-1)
    fj = torch.cat([idx.expand(*lead, k), zero1, lj, gj], dim=-1)
    pose_ids = torch.cat([fi, fj], dim=-1) + _instance_offsets(lead, k, dev)
    return FactorBlocks(
        i=fi,
        j=fj,
        jac_i=torch.cat([ji_o, torch.zeros_like(jj_p), ji_l, ji_g], dim=-3),
        jac_j=torch.cat([jj_o, jj_p, jj_l, jj_g], dim=-3),
        info_w=torch.cat([info_o, info_p, info_l, info_g], dim=-2),
        res=torch.cat([res_o, res_p, res_l, res_g], dim=-2),
        valid=torch.cat([odom_valid.expand(*lead, k),
                         torch.ones(*lead, 1, dtype=torch.bool, device=dev), valid_l, valid_g],
                        dim=-1),
        pose_segs=segments(pose_ids.reshape(-1), math.prod(lead) * k),
    )


def _pose_sum(blocks: FactorBlocks, per_i: torch.Tensor, per_j: torch.Tensor,
              k: int) -> torch.Tensor:
    """Per pose, the sum of per_i [..., F, *rest] at pose i and per_j at
    pose j of each factor: [..., K, *rest]."""
    lead, rest = blocks.i.shape[:-1], per_i.shape[blocks.i.dim():]
    vals = torch.cat([per_i, per_j], dim=len(lead)).reshape(-1, *rest)
    return segment_sum(vals, blocks.pose_segs).reshape(*lead, k, *rest)


def _weighted(blocks: FactorBlocks, jac: torch.Tensor) -> torch.Tensor:
    """W J per factor (invalid factors zeroed): [..., F, 6, 6]."""
    w = blocks.valid[..., None].to(jac.dtype)
    return jac * (blocks.info_w * w)[..., None]


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _hessian_diag_blocks(blocks: FactorBlocks, k: int) -> torch.Tensor:
    """[..., K, 6, 6] block diagonal of H (solver.py:119-127)."""
    hii = mm(_t(blocks.jac_i), _weighted(blocks, blocks.jac_i))
    hjj = mm(_t(blocks.jac_j), _weighted(blocks, blocks.jac_j))
    return _pose_sum(blocks, hii, hjj, k)


def _scatter_jt(blocks: FactorBlocks, u: torch.Tensor, k: int) -> torch.Tensor:
    """sum over factors of J_i^T u at pose i and J_j^T u at pose j: [..., K, 6]."""
    return _pose_sum(blocks, mm(_t(blocks.jac_i), u[..., None])[..., 0],
                     mm(_t(blocks.jac_j), u[..., None])[..., 0], k)


def _matvec(blocks: FactorBlocks, v: torch.Tensor, damping: float) -> torch.Tensor:
    """(H + damping I) v without materializing H; v [..., K, 6]."""
    w = blocks.valid[..., None].to(v.dtype)
    u = (mm(blocks.jac_i, _take_pose(v, blocks.i)[..., None])[..., 0]
         + mm(blocks.jac_j, _take_pose(v, blocks.j)[..., None])[..., 0]) * blocks.info_w * w
    return _scatter_jt(blocks, u, v.shape[-2]) + damping * v


def _gradient(blocks: FactorBlocks, k: int) -> torch.Tensor:
    """g = J^T W r, [..., K, 6]."""
    w = blocks.valid[..., None].to(blocks.res.dtype)
    return _scatter_jt(blocks, blocks.info_w * blocks.res * w, k)


def _chi2(blocks: FactorBlocks) -> torch.Tensor:
    """Weighted chi^2 of each graph, [...]."""
    terms = blocks.valid[..., None] * blocks.info_w * blocks.res ** 2
    return fixed_sum(terms.flatten(-2))


class GraphSolution(NamedTuple):
    rot: torch.Tensor
    trans: torch.Tensor
    iterations: torch.Tensor  # GN iterations applied
    final_error: torch.Tensor  # weighted chi^2 at the returned poses
    converged: torch.Tensor  # [] bool


def _chain_offdiag(blocks: FactorBlocks, k: int) -> torch.Tensor:
    """[..., K, 6, 6] blocks B_f = H_{f-1,f} of the odometry chain (rows [0, K))."""
    return mm(_t(blocks.jac_i[..., :k, :, :]), _weighted(blocks, blocks.jac_j)[..., :k, :, :])


def graph_chi2(graph: PoseGraph, rot, trans, count) -> torch.Tensor:
    """Weighted chi^2 (with Cauchy IRLS weights) at the given poses."""
    return _chi2(_linearize(graph, rot, trans, count))


def _damped_diagonal(active: torch.Tensor, damping, dtype) -> torch.Tensor:
    """[..., K]: `damping` at active poses, 1 at the others."""
    return torch.where(active[..., 0], torch.as_tensor(damping, dtype=dtype,
                                                       device=active.device), 1.0)


def _dense_hessian(blocks: FactorBlocks, k: int, damping, active: torch.Tensor) -> torch.Tensor:
    """H = J^T W J as a dense [..., 6K, 6K] matrix, inactive poses on an
    identity diagonal so the Cholesky stays SPD (solver.py:225-267)."""
    lead = blocks.i.shape[:-1]
    wj_i = _weighted(blocks, blocks.jac_i)
    wj_j = _weighted(blocks, blocks.jac_j)
    hii = mm(_t(blocks.jac_i), wj_i)
    hjj = mm(_t(blocks.jac_j), wj_j)
    hij = mm(_t(blocks.jac_i), wj_j)
    bi, bj = blocks.i, blocks.j
    idx = torch.cat([bi * k + bi, bj * k + bj, bi * k + bj, bj * k + bi], dim=-1)
    idx = idx + _instance_offsets(lead, k * k, idx.device)
    upd = torch.cat([hii, hjj, hij, _t(hij)], dim=-3).reshape(-1, 36)  # [4F, 36] per instance
    flat = segment_sum(upd, segments(idx.reshape(-1), math.prod(lead) * k * k))
    h = flat.reshape(*lead, k, k, 6, 6).transpose(-3, -2).reshape(*lead, k * 6, k * 6)
    diag = _damped_diagonal(active, damping, h.dtype).repeat_interleave(6, dim=-1)
    return h + torch.diag_embed(diag)


def _chain_parts(blocks: FactorBlocks, k: int, damping, active):
    """H = T + V V^T: the block-tridiagonal chain part T (diagonal blocks d
    [..., K, 6, 6] with damping, super-diagonal e [..., K-1, 6, 6]) and the
    loop/prior columns v [..., K, 6, R], R = 6 * (loop + prior capacity)
    (solver.py:270-313)."""
    dtype, dev = blocks.res.dtype, blocks.res.device
    lead = blocks.i.shape[:-1]
    ji, jj = blocks.jac_i[..., :k, :, :], blocks.jac_j[..., :k, :, :]
    wji = _weighted(blocks, blocks.jac_i)[..., :k, :, :]
    wjj = _weighted(blocks, blocks.jac_j)[..., :k, :, :]
    # chain row f adds J_i^T W J_i at pose max(f - 1, 0) and J_j^T W J_j at
    # pose f: the first term shifted down one pose, rows 0 and 1 both at pose 0
    hii = mm(_t(ji), wji)
    shifted = torch.cat([hii[..., 1:, :, :], torch.zeros_like(hii[..., :1, :, :])], dim=-3)
    shifted = torch.cat([shifted[..., :1, :, :] + hii[..., :1, :, :], shifted[..., 1:, :, :]],
                        dim=-3)
    d = shifted + mm(_t(jj), wjj)
    e = mm(_t(ji), wjj)[..., 1:, :, :]
    jp = blocks.jac_j[..., k, :, :]  # first-pose anchor: jac_i is zero by construction
    wp = blocks.info_w[..., k, :] * blocks.valid[..., k, None].to(dtype)
    d[..., 0, :, :] += mm(_t(jp), jp * wp[..., :, None])
    d = d + (_damped_diagonal(active, damping, dtype)[..., None, None]
             * torch.eye(6, dtype=dtype, device=dev))

    f2 = blocks.i.shape[-1] - (k + 1)
    s = torch.sqrt(blocks.info_w[..., k + 1:, :] * blocks.valid[..., k + 1:, None])
    ci = _t(blocks.jac_i[..., k + 1:, :, :]) * s[..., None, :]
    cj = _t(blocks.jac_j[..., k + 1:, :, :]) * s[..., None, :]
    offs = _instance_offsets(lead, k, dev)
    fi = (blocks.i[..., k + 1:] + offs).reshape(-1)
    fj = (blocks.j[..., k + 1:] + offs).reshape(-1)
    ar = torch.arange(f2, device=dev).expand(*lead, f2).reshape(-1)
    # each factor column holds its two poses' blocks, summed where i == j:
    # (pose, factor) pairs are unique, so these writes need no accumulation
    v4 = blocks.res.new_zeros(math.prod(lead) * k, f2, 6, 6)
    v4.index_put_((fi, ar), ci.reshape(-1, 6, 6))
    v4.index_put_((fj, ar), v4[fj, ar] + cj.reshape(-1, 6, 6))
    v = v4.reshape(*lead, k, f2, 6, 6).transpose(-3, -2).reshape(*lead, k, 6, f2 * 6)
    return d, e, v


def _bcr_solve(d: torch.Tensor, e: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve T X = B for SPD block-tridiagonal T by block cyclic reduction
    (solver.py:316-369): eliminate every odd node at once and recurse on the
    even half, O(log K) levels of batched 6x6 ops. The level loop has static
    shapes, so it is a plain Python loop.

    d: [..., K, 6, 6]; e: [..., K-1, 6, 6] with T[k, k+1] = e[k]; b:
    [..., K, 6, R]."""
    k_orig = d.shape[-3]
    eye = torch.eye(6, dtype=d.dtype, device=d.device)

    def pad1(x, fill=None):  # one more node at the end of dim -3
        extra = x.new_zeros(*x.shape[:-3], 1, *x.shape[-2:]) if fill is None else \
            fill.expand(*x.shape[:-3], 1, *x.shape[-2:])
        return torch.cat([x, extra], dim=-3)

    levels = []
    while d.shape[-3] > 1:
        if d.shape[-3] % 2 == 1:  # a decoupled identity node (exact no-op)
            d, e, b = pad1(d, eye), pad1(e), pad1(b)
        e_pad = pad1(e)
        dinv = inv_psd_unrolled(d[..., 1::2, :, :], 6)
        b_odd = b[..., 1::2, :, :]
        el = e[..., 0::2, :, :]  # couples even node 2j to odd 2j+1
        er = e_pad[..., 1::2, :, :]  # couples odd 2j+1 to even 2j+2 (zero-padded)
        a_r = mm(el, dinv)
        d_new = d[..., 0::2, :, :] - mm(a_r, _t(el))
        b_new = b[..., 0::2, :, :] - mm(a_r, b_odd)
        a_l = mm(_t(er), dinv)
        d_new[..., 1:, :, :] -= mm(a_l, er)[..., :-1, :, :]
        b_new[..., 1:, :, :] -= mm(a_l, b_odd)[..., :-1, :, :]
        e_new = -mm(a_r, er)[..., :-1, :, :]
        levels.append((dinv, el, er, b_odd))
        d, e, b = d_new, e_new, b_new

    x = cholesky_solve_unrolled_mat(d[..., 0, :, :], b[..., 0, :, :], 6)[..., None, :, :]
    for dinv, el, er, b_odd in reversed(levels):
        n = dinv.shape[-3]
        x_even = x[..., :n, :, :]
        t = b_odd - mm(_t(el), x_even)
        x_shift = torch.cat([x_even[..., 1:, :, :], torch.zeros_like(x_even[..., :1, :, :])],
                            dim=-3)
        t = t - mm(er, x_shift)
        x_odd = mm(dinv, t)
        x = torch.stack([x_even, x_odd], dim=-3).reshape(*x_even.shape[:-3], 2 * n,
                                                         *x_even.shape[-2:])
    return x[..., :k_orig, :, :]


def _cholesky(h: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; like the reference's cho_factor it does not
    raise (or sync the device) on a matrix that is not positive definite."""
    return torch.linalg.cholesky_ex(h)[0]


def _each(fn, *args):
    """fn on each instance of args [*lead, ...] (the graphs' batch dims
    flattened), one call apiece (`ops.linalg.each`): on the card a batched
    Cholesky or matmul takes other kernels than a single one."""
    lead = args[0].shape[:-2]
    out = each(fn, *(a.reshape(-1, *a.shape[len(lead):]) for a in args))
    return out.reshape(*lead, *out.shape[1:])


def _bcr_step(blocks: FactorBlocks, k: int, damping, active, g) -> torch.Tensor:
    """One GN direction: H^-1 b = T^-1 b - T^-1 V (I + V^T T^-1 V)^-1 V^T T^-1 b
    with T solved by `_bcr_solve` (solver.py:372-390)."""
    d, e, v = _chain_parts(blocks, k, damping, active)
    b = (-g * active)[..., None]
    x = _bcr_solve(d, e, torch.cat([b, v], dim=-1))
    tinv_b, tinv_v = x[..., 0], x[..., 1:]
    lead, r = v.shape[:-3], v.shape[-1]

    def woodbury(v2, tv2, tb):
        s = torch.eye(r, dtype=v2.dtype, device=v2.device) + v2.T @ tv2
        z = torch.cholesky_solve((v2.T @ tb)[:, None], _cholesky(s))[:, 0]
        return tb - tv2 @ z

    corr = _each(woodbury, v.reshape(*lead, k * 6, r), tinv_v.reshape(*lead, k * 6, r),
                 tinv_b.reshape(*lead, k * 6))
    return corr.reshape(*lead, k, 6) * active


def _pcg(blocks: FactorBlocks, k: int, damping: float, active, g, cg_iterations: int,
         cg_tol: float, preconditioner: str):
    """PCG for (H + damping I) x = -g from x = 0 (solver.py:472-508), over
    the graphs' batch dims as `jax.vmap` of the reference's while_loop runs
    it: each graph keeps its own CG state and stops when its r.z drops below
    cg_tol^2 of its own initial value; a stopped graph's state is frozen by
    selection while the loop runs on for the others, with one host read per
    iteration. The dot products are `fixed_sum`s and the Jacobi inverse one
    call per graph, so a batch gives each graph its bits alone. Returns x
    [..., K, 6] and the CG iterations each graph took [...]."""
    eye6 = torch.eye(6, dtype=g.dtype, device=g.device)
    diag = _hessian_diag_blocks(blocks, k) + damping * eye6
    if preconditioner == "chain":
        # the reference's block-Thomas factorization and its three scans solve
        # exactly this block-tridiagonal system; cyclic reduction solves it in
        # O(log K) batched levels instead of K sequential steps
        offdiag = _chain_offdiag(blocks, k)[..., 1:, :, :]

        def precond(r):
            return _bcr_solve(diag, offdiag, r[..., None])[..., 0]
    elif preconditioner == "jacobi":
        lead = diag.shape[:-3]
        pinv = each(torch.linalg.inv, diag.reshape(-1, k, 6, 6)).reshape(*lead, k, 6, 6)

        def precond(r):
            return mm(pinv, r[..., None])[..., 0]
    else:
        raise ValueError(f"unknown preconditioner {preconditioner!r}")

    def dot(u, v):
        return fixed_sum((u * v).flatten(-2))

    b = -g * active
    x = torch.zeros_like(b)
    r = b
    p = precond(r) * active
    rz = dot(r, p)
    floor = cg_tol * cg_tol * rz
    run = rz > floor
    steps = torch.zeros(run.shape, dtype=torch.int32, device=run.device)
    for _ in range(cg_iterations):
        if not profiling.host_read(run.any()):
            break
        ap = _matvec(blocks, p, damping) * active
        alpha = (rz / torch.clamp(dot(p, ap), min=1e-30))[..., None, None]
        r_new = r - alpha * ap
        z = precond(r_new) * active
        rz_new = dot(r_new, z)
        beta = (rz_new / torch.clamp(rz, min=1e-30))[..., None, None]
        # a stopped graph keeps its state: selection, not a 0/1 product
        # (0 * inf is NaN, and r.z may reach 0)
        keep = run[..., None, None]
        x = torch.where(keep, x + alpha * p, x)
        r = torch.where(keep, r_new, r)
        p = torch.where(keep, z + beta * p, p)
        rz = torch.where(run, rz_new, rz)
        steps = steps + run.to(torch.int32)
        run = rz > floor
    return x, steps


def solve_pose_graph(graph: PoseGraph, rot: torch.Tensor, trans: torch.Tensor, count,
                     gn_iterations: int = 8, cg_iterations: int = 1000, cg_tol: float = 1e-8,
                     damping: float = 1e-6, gn_tol: float = 1e-9,
                     preconditioner: str = "chain", method: str = "pcg") -> GraphSolution:
    """Full Gauss-Newton re-solve of the pose graph (solver.py:393-537).

    Poses at index >= count stay fixed; active poses update by right
    multiplication with Exp(delta). GN stops when chi^2 changes by no more
    than gn_tol * (chi^2 at the start + 1) between iterations; `final_error`
    is chi^2 at the returned poses. Full f32 (the caller turns TF32 off,
    `runtime.platform.configure_precision`).

    rot [B, K, 3, 3] (with trans, count and every graph field leading with
    [B]) solves B graphs with any method: each stops on its own GN (and CG)
    test, the loops run while any has not, with one host read per
    iteration, and the solution's fields lead with [B]."""
    if method not in ("bcr", "dense", "pcg"):
        raise ValueError(f"unknown method {method!r}")
    lead, k = rot.shape[:-3], rot.shape[-3]
    dev = trans.device
    count = torch.as_tensor(count, device=dev)
    active = (torch.arange(k, device=dev) < count[..., None])[..., None]
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    iters = torch.zeros(lead, dtype=torch.int32, device=dev)
    prev_err = err0 = None
    for it in range(gn_iterations):
        blocks = _linearize(graph, rot, trans, count)
        err_here = _chi2(blocks)
        if it == 0:
            err0 = err_here
        else:
            # the reference also solves on the iteration that stops and then
            # discards the step; checking first gives the same poses
            done = done | (torch.abs(prev_err - err_here) <= gn_tol * (err0 + 1.0))
            if profiling.host_read(done.all()):
                break
        prev_err = err_here
        g = _gradient(blocks, k)
        if method == "dense":
            h = _dense_hessian(blocks, k, damping, active)
            x = _each(lambda hh, bb: torch.cholesky_solve(bb, _cholesky(hh)), h,
                      (-g * active).reshape(*lead, k * 6, 1)).reshape(*lead, k, 6)
        elif method == "bcr":
            x = _bcr_step(blocks, k, damping, active, g)
        else:
            x, _ = _pcg(blocks, k, damping, active, g, cg_iterations, cg_tol, preconditioner)
        new = SE3(rot, trans).compose(_each_on_cpu(se3.exp, lead, x * active))
        keep = done[..., None, None]
        rot = torch.where(keep[..., None], rot, new.rot)
        trans = torch.where(keep, trans, new.trans)
        iters = iters + (~done).to(torch.int32)
    final_err = graph_chi2(graph, rot, trans, count)
    return GraphSolution(rot, trans, iters, final_err, done)


def inv3x3_blocks6(m: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse for the block-Jacobi preconditioner
    (solver.py:540-543)."""
    return torch.linalg.inv(m)


def marginal_covariance(graph: PoseGraph, rot: torch.Tensor, trans: torch.Tensor, count,
                        keys: torch.Tensor, damping: float = 1e-6) -> torch.Tensor:
    """[M, 6, 6] diagonal blocks of H^{-1} for pose indices `keys` [M]: the
    isam->marginalCovariance analog (solver.py:545-581), by Cholesky column
    solves on the dense Hessian, in (rotvec, translation) order."""
    k = rot.shape[0]
    dev = trans.device
    count = torch.as_tensor(count, device=dev)
    active = (torch.arange(k, device=dev) < count)[:, None]
    blocks = _linearize(graph, rot, trans, count)
    chol = _cholesky(_dense_hessian(blocks, k, damping, active))
    keys = torch.as_tensor(keys, device=dev).long()
    m = keys.shape[0]
    rows = keys[:, None] * 6 + torch.arange(6, device=dev)  # [M, 6]
    rhs = trans.new_zeros(k * 6, m * 6)
    rhs[rows.reshape(-1), torch.arange(m * 6, device=dev)] = 1.0
    x = torch.cholesky_solve(rhs, chol).reshape(k * 6, m, 6)
    return x[rows, torch.arange(m, device=dev)[:, None]]

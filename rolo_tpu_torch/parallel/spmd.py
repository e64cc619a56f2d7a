"""Point-axis SPMD registration: one scan pair with its source points split
over the ranks of a process group, the counterpart of
`rolo_tpu/parallel/spmd.py`.

Every rank linearizes its shard of the correspondences, and the small dense
results (the 3x3 / 6x6 Hessians, the gradients, the errors and the
correspondence count) are summed with one `all_reduce` per call: the
reference's psum. All ranks then hold the same bits, so the LM loops of
registration/lm.py take the same branches everywhere: every host check in
this path reads only reduced values, and a branch on a rank's own data
would leave the group waiting in a collective.

Per rank, for D ranks and N source points: the source covariances query
the N/D local points against the all-gathered source (kernel K2 with
Q = N/D); the target covariances come from a 1/D slice, all-gathered; the
voxel maps (kernel K1) are built whole on every rank. The alternating
rotation / translation rounds and the fine CT stage are
rotgicp.register_features' own, run with the all-reducing hooks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import RegistrationConfig
from ..registration import gicp
from ..registration.rotgicp import ScanPairResult, register_features
from ..voxel.knn import estimate_cov6


def _all_reduce(tensors, group):
    """Sum a tuple of [B, ...] tensors over the group in one collective."""
    flat = torch.cat([t.reshape(t.shape[0], -1).to(torch.float32) for t in tensors], dim=1)
    dist.all_reduce(flat, group=group)
    out, col = [], 0
    for t in tensors:
        width = t[0].numel()
        out.append(flat[:, col:col + width].reshape(t.shape).to(t.dtype))
        col += width
    return tuple(out)


def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's x, concatenated in rank order along `dim`; bool as uint8."""
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if x.dtype == torch.bool else out


def _reducers(group):
    """The objective hooks of lm.py with group-wide sums."""

    def so3_linearize(ctx, corr, rot, trans):
        return _all_reduce(gicp.so3_linearize(ctx, corr, rot, trans), group)

    def compute_error(ctx, corr, rot, trans):
        return _all_reduce((gicp.compute_error(ctx, corr, rot, trans),), group)[0]

    def n_corr(ctx, corr, t):
        count = gicp.ct_n_corr(corr).to(t.dtype)
        dist.all_reduce(count, group=group)
        return torch.clamp(count, min=1.0)

    def ct_linearize(ctx, corr, t, g, last, dtn, dtn1, ct_lambda):
        return _all_reduce(gicp.ct_linearize(ctx, corr, t, g, last, dtn, dtn1, ct_lambda,
                                             n_corr_override=n_corr(ctx, corr, t)), group)

    def ct_error(ctx, corr, t, g, last, dtn, dtn1, ct_lambda):
        return _all_reduce((gicp.ct_error(ctx, corr, t, g, last, dtn, dtn1, ct_lambda,
                                          n_corr_override=n_corr(ctx, corr, t)),), group)[0]

    return so3_linearize, compute_error, ct_linearize, ct_error


def _group_of(group_or_mesh, axis_name: str):
    """A ProcessGroup as given, a DeviceMesh's group along `axis_name`, or
    the default group for None."""
    if group_or_mesh is not None and hasattr(group_or_mesh, "get_group"):
        return group_or_mesh.get_group(axis_name)
    return group_or_mesh


def register_scan_pair_spmd(group_or_mesh, src_xyz, src_mask, tgt_xyz, tgt_mask,
                            init_translation, last_translation, interval_tn, interval_tn_1,
                            cfg: RegistrationConfig = RegistrationConfig(),
                            voxel_capacity: int = 8192, k: int = 20,
                            axis_name: str = "point") -> ScanPairResult:
    """One rot-GICP scan-pair registration with the point axis split over a
    process group (spmd.py:85-254): a ProcessGroup, a DeviceMesh (its
    `axis_name` axis), or None for the default group.

    The contract of registration.rotgicp.register_scan_pair for one pair:
    every rank passes the whole clouds, src_xyz [N, 3] and tgt_xyz [M, 3]
    with their masks, the forward-predicted step `init_translation` [3],
    and gets the same total step back (unbatched fields). Rank r works on
    source rows [r N/D, (r+1) N/D). N and M must divide by the group size
    D. The rounds are register_features' with all-reducing objective hooks,
    on the local shard against voxel maps of the whole target (kernel K1,
    built on every rank); the results match the one-device path up to the
    order of the reductions."""
    group = _group_of(group_or_mesh, axis_name)
    d, rank = dist.get_world_size(group), dist.get_rank(group)
    n_src, n_tgt = src_xyz.shape[0], tgt_xyz.shape[0]
    if n_src % d or n_tgt % d:
        raise ValueError(f"point counts ({n_src}, {n_tgt}) must divide the group size {d}")
    dt, dev = src_xyz.dtype, src_xyz.device
    ns, nt = n_src // d, n_tgt // d

    # source covariances: the local shard against the gathered source
    src = src_xyz[rank * ns:(rank + 1) * ns][None]
    smask = src_mask[rank * ns:(rank + 1) * ns][None]
    full_src = _all_gather(src[0], group)[None]
    full_smask = _all_gather(smask[0], group)[None]
    src_cov = estimate_cov6(src, smask, k=k, method=cfg.regularization, cand_xyz=full_src,
                            cand_mask=full_smask)
    # target covariances: a 1/D slice each, gathered into the whole planes
    tgt, tmask = tgt_xyz[None], tgt_mask[None]
    rows = slice(rank * nt, (rank + 1) * nt)
    tcov_loc = estimate_cov6(tgt[:, rows], tmask[:, rows], k=k, method=cfg.regularization,
                             cand_xyz=tgt, cand_mask=tmask)
    tgt_cov = _all_gather(tcov_loc[0], group, dim=1)[None]

    res = register_features(src, smask, src_cov, tgt, tmask, tgt_cov,
                            torch.as_tensor(init_translation, dtype=dt, device=dev).reshape(1, 3),
                            torch.as_tensor(last_translation, dtype=dt, device=dev).reshape(1, 3),
                            torch.as_tensor(interval_tn, dtype=dt, device=dev).reshape(1),
                            torch.as_tensor(interval_tn_1, dtype=dt, device=dev).reshape(1),
                            cfg, voxel_capacity, objective=_reducers(group))
    return ScanPairResult(*(field[0] for field in res))

"""Loop-closure candidate search, submap assembly and ICP verification,
torch port of `rolo_tpu/loop/closure.py` (backMapping's loop-closure thread).

- `detect_loop_distance`: the nearest older keyframe within the history
  radius and more than `history_search_time_diff` apart, a masked argmin.
- `assemble_loop_submap`: the clouds of keyframes key +- search_num in world
  coordinates, voxel-downsampled.
- `icp_point2point`: masked point-to-point ICP. The reference's
  `lax.while_loop` is a Python loop with one host check of the epsilon test
  per iteration; correspondences come from the exact matmul-form 1-NN
  (`knn_indices(k=1)`). The Kabsch rotation is the reference's SVD form
  (`kabsch_rotation`). On CUDA `torch.linalg.svd` checks its `info` on the
  host, a second sync per iteration; it waits only for the 1-NN work the
  end-of-iteration check waits for anyway, and measured cheaper per
  iteration than a closed form through `ops/eig3.py` (~120 small launches).
- `verify_loop`: ICP from the scan-context yaw and the between factor.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Tuple

import torch

from ..geometry.se3 import SE3
from ..ops.rows import read_row
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..runtime import profiling
from ..voxel.knn import knn_indices

if TYPE_CHECKING:  # annotation only: mapping imports this module
    from ..mapping.keyframes import KeyframeDB


def detect_loop_distance(db: KeyframeDB, already_matched: torch.Tensor, search_radius: float,
                         time_diff: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """For the latest keyframe, the nearest older keyframe within
    `search_radius` whose time differs by more than `time_diff`; keyframes
    that already own a loop factor (`already_matched` [K]) find nothing
    (closure.py:41-67). Returns (prev_index, found)."""
    cur = torch.clamp(db.count.long() - 1, min=0)
    d2 = torch.sum((db.trans - read_row(db.trans, cur)) ** 2, dim=-1)
    ok = (db.valid() & (d2 <= search_radius ** 2)
          & (torch.abs(db.time - read_row(db.time, cur)) > time_diff)
          & (torch.arange(db.capacity, device=d2.device) != cur))
    score = torch.where(ok, d2, float("inf"))
    prev = torch.argmin(score)
    found = torch.isfinite(score[prev]) & ~read_row(already_matched, cur) & (db.count > 0)
    return prev.to(torch.int32), found


def assemble_loop_submap(db: KeyframeDB, key, search_num: int, out_capacity: int,
                         leaf: float) -> PaddedCloud:
    """Corner and surface clouds of keyframes [key - search_num, key +
    search_num], each moved to world coordinates by its own pose, then
    voxel-downsampled to `out_capacity` (closure.py:70-95)."""
    dev = db.count.device
    idx = torch.as_tensor(key, device=dev).long() + torch.arange(-search_num, search_num + 1,
                                                                 device=dev)
    in_range = (idx >= 0) & (idx < db.count)
    idx = torch.clamp(idx, 0, db.capacity - 1)
    rot, trans = db.rot[idx], db.trans[idx]

    def to_world(xyz, mask):
        world = xyz[idx] @ rot.transpose(-1, -2) + trans[:, None, :]
        return world.reshape(-1, 3), (mask[idx] & in_range[:, None]).reshape(-1)

    cx, cm = to_world(db.corner_xyz, db.corner_mask)
    sx, sm = to_world(db.surf_xyz, db.surf_mask)
    return voxel_downsample(PaddedCloud(torch.cat([cx, sx]), torch.cat([cm, sm])), leaf,
                            out_capacity)


def kabsch_rotation(h: torch.Tensor) -> torch.Tensor:
    """The rotation R minimising sum w |R a - b|^2 from the 3x3 cross
    covariance h = sum w (a - ca)(b - cb)^T: V diag(1, 1, det(V U^T)) U^T of
    the SVD h = U S V^T (closure.py:152-155)."""
    u, _, vt = torch.linalg.svd(h)
    d = torch.linalg.det(vt.T @ u.T)
    one = torch.ones_like(d)
    return vt.T @ torch.diag(torch.stack([one, one, d])) @ u.T


class ICPResult(NamedTuple):
    rot: torch.Tensor  # [3, 3]
    trans: torch.Tensor  # [3]
    fitness: torch.Tensor  # mean squared correspondence distance
    converged: torch.Tensor  # bool


def icp_point2point(src: PaddedCloud, tgt: PaddedCloud, init_rot: torch.Tensor,
                    init_trans: torch.Tensor, max_corr_dist: float, max_iterations: int = 100,
                    transformation_epsilon: float = 1e-4, chunk: int = 512,
                    approx_knn: bool = False) -> ICPResult:
    """Masked point-to-point ICP (closure.py:105-192): nearest-neighbour
    correspondences gated by `max_corr_dist`, the Kabsch pose re-estimated
    from the original source points each iteration, stopping once the pose
    moves less than `transformation_epsilon` (the f32 value the reference
    documents at :113-123) or after `max_iterations`. Fitness is the mean
    squared nearest-neighbour distance of all valid source points under the
    result; `converged` means at least 3 gated correspondences (pcl's
    hasConverged semantics, :181-191). `approx_knn` is accepted for the
    reference's signature; the search is exact either way."""
    del approx_knn
    eye4 = torch.eye(4, dtype=src.xyz.dtype, device=src.xyz.device)
    gate = max_corr_dist ** 2
    w_src = src.mask.to(src.xyz.dtype)

    def nearest(rot, trans):
        moved = src.xyz @ rot.T + trans
        idx = knn_indices(moved, src.mask, tgt.xyz, tgt.mask, 1, chunk)[:, 0]
        nn = tgt.xyz[idx]
        return idx, nn, torch.sum((moved - nn) ** 2, dim=-1)

    rot, trans = init_rot, init_trans
    for _ in range(max_iterations):
        _, nn, d2 = nearest(rot, trans)
        w = w_src * (d2 < gate)
        wsum = torch.clamp(w.sum(), min=1e-6)
        cs = (w[:, None] * src.xyz).sum(0) / wsum
        ct = (w[:, None] * nn).sum(0) / wsum
        h = torch.einsum("n,ni,nj->ij", w, src.xyz - cs, nn - ct)
        new_rot = kabsch_rotation(h)
        new_trans = ct - new_rot @ cs
        step = SE3(rot, trans).inverse().compose(SE3(new_rot, new_trans)).as_matrix()
        rot, trans = new_rot, new_trans
        if profiling.host_read(torch.max(torch.abs(step - eye4)) < transformation_epsilon):
            break

    idx, _, d2 = nearest(rot, trans)
    fitness = torch.sum(w_src * d2) / torch.clamp(w_src.sum(), min=1e-6)
    n_corr = torch.sum(src.mask & tgt.mask[idx] & (d2 < gate))
    return ICPResult(rot, trans, fitness, n_corr >= 3)


class LoopFactor(NamedTuple):
    """One verified loop constraint ready for graph insertion."""

    i: torch.Tensor  # cur keyframe index
    j: torch.Tensor  # prev keyframe index
    rel_rot: torch.Tensor  # [3, 3] measured T_i^-1 T_j
    rel_trans: torch.Tensor  # [3]
    noise_var: torch.Tensor  # [6]
    robust_c: torch.Tensor  # [] Cauchy k (0 = gaussian)
    accepted: torch.Tensor  # bool


def verify_loop(db: KeyframeDB, cur_key, prev_key, cur_submap: PaddedCloud,
                prev_submap: PaddedCloud, init_yaw, max_corr_dist: float,
                fitness_threshold: float, robust: bool, max_iterations: int = 100,
                approx_knn: bool = False) -> LoopFactor:
    """ICP-verify a loop candidate from the scan-context yaw (0 for radius
    loops) and build its between factor pose_from^-1 pose_to, pose_from =
    icp o T_cur, pose_to = T_prev, isotropic variance = fitness; accepted
    when the fitness is finite and below the threshold (closure.py:207-260)."""
    dtype, dev = db.trans.dtype, db.trans.device
    cur_key = torch.as_tensor(cur_key, device=dev)
    prev_key = torch.as_tensor(prev_key, device=dev)
    yaw = torch.as_tensor(init_yaw, dtype=dtype, device=dev)
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    init_rot = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                            torch.stack([zero, zero, one])])
    icp = icp_point2point(cur_submap, prev_submap, init_rot, torch.zeros(3, dtype=dtype,
                                                                         device=dev),
                          max_corr_dist=max_corr_dist, max_iterations=max_iterations,
                          approx_knn=approx_knn)
    t_cur = SE3(read_row(db.rot, cur_key), read_row(db.trans, cur_key))
    t_prev = SE3(read_row(db.rot, prev_key), read_row(db.trans, prev_key))
    rel = SE3(icp.rot, icp.trans).compose(t_cur).inverse().compose(t_prev)
    accepted = torch.isfinite(icp.fitness) & (icp.fitness < fitness_threshold) & (
        cur_key != prev_key)
    return LoopFactor(
        i=cur_key.to(torch.int32), j=prev_key.to(torch.int32), rel_rot=rel.rot,
        rel_trans=rel.trans, noise_var=torch.clamp(icp.fitness, min=1e-6).expand(6).clone(),
        robust_c=torch.tensor(1.0 if robust else 0.0, dtype=dtype, device=dev),
        accepted=accepted)

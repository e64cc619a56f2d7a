"""Plain reference of the radius-search loop closure: the candidate search,
point-to-point ICP, its fitness, the acceptance and the between factor.

Written from the reference system's description (ROLO-SLAM's
loop-closure thread: `detectLoopClosureDistance`, pcl's
`IterativeClosestPoint` with its SVD transform estimation and
`getFitnessScore`, `performRSLoopClosure`), not from the program, and run in
float64 by default. It imports nothing of the program. It starts from the
program's own inputs (the keyframe rows and the two assembled submaps), as
`reference/steps` starts from the front-end's.

- `detect_radius`: the latest keyframe's nearest keyframe, within
  `history_search_radius` and more than `history_search_time_diff` older or
  newer; none when the latest keyframe already owns a loop.
- `icp`: brute-force nearest neighbours of every valid source point among
  the valid target points, pairs farther than `max_corr_dist` left out, the
  rigid transform of the pairs by SVD (Kabsch, with the reflection fixed),
  re-estimated from the original source points each iteration; it stops
  once an iteration moves the pose by less than `epsilon` in every entry of
  the 4 x 4 matrix, or after `max_iterations`.
- `verify`: the fitness (the mean squared nearest-neighbour distance of all
  valid source points under the result, no gate), the acceptance (at least 3
  gated pairs, pcl's `hasConverged`, and the fitness under
  `history_fitness_score`) and the factor: the relative pose
  (icp o T_cur)^-1 o T_prev with an isotropic variance equal to the fitness;
  from the yaw, or from where a given factor's ICP ended (`icp_pose_of`), to
  ask whether that factor is a converged ICP solution.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

DTYPE = torch.float64


def detect_radius(trans: torch.Tensor, time: torch.Tensor, count: int, matched: torch.Tensor,
                  radius: float, time_diff: float) -> Optional[int]:
    """trans [K, 3], time [K], matched [K] bool of a keyframe store whose
    first `count` rows are live: the index of the loop candidate of keyframe
    count - 1, or None."""
    if count < 2:
        return None
    cur = count - 1
    if bool(matched[cur]):
        return None
    trans = trans[:count].to(DTYPE)
    time = time[:count].to(DTYPE)
    d2 = ((trans - trans[cur]) ** 2).sum(-1)
    ok = (d2 <= radius * radius) & ((time - time[cur]).abs() > time_diff)
    ok[cur] = False
    if not bool(ok.any()):
        return None
    d2 = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    return int(torch.argmin(d2))


def _nearest(points: torch.Tensor, target: torch.Tensor, chunk: int = 512):
    """Each point's squared distance to its nearest target point and that
    point's index, by brute force."""
    d2, idx = [], []
    for i in range(0, points.shape[0], chunk):
        diff = points[i:i + chunk, None, :] - target[None, :, :]
        best = (diff * diff).sum(-1).min(dim=1)
        d2.append(best.values)
        idx.append(best.indices)
    return torch.cat(d2), torch.cat(idx)


def _kabsch(a: torch.Tensor, b: torch.Tensor):
    """The rotation and translation taking points a [P, 3] onto b [P, 3] in
    the least-squares sense: H = sum (a - ca)(b - cb)^T = U S V^T, R = V
    diag(1, 1, det(V U^T)) U^T, t = cb - R ca. The SVD of the 3 x 3 matrix
    runs in float32 at least (there is none in bfloat16)."""
    ca, cb = a.mean(0), b.mean(0)
    h = (a - ca).T @ (b - cb)
    work = h.to(torch.promote_types(h.dtype, torch.float32))
    u, _, vt = torch.linalg.svd(work)
    v = vt.T
    d = torch.ones(3, dtype=work.dtype, device=work.device)
    d[2] = torch.linalg.det(v @ u.T)
    rot = (v @ torch.diag(d) @ u.T).to(h.dtype)
    return rot, cb - rot @ ca


class ICP(NamedTuple):
    rot: torch.Tensor  # [3, 3]
    trans: torch.Tensor  # [3]
    fitness: float
    pairs: int  # gated nearest-neighbour pairs under the result
    iterations: int


def icp(src: torch.Tensor, src_mask: torch.Tensor, tgt: torch.Tensor, tgt_mask: torch.Tensor,
        init_rot: torch.Tensor, init_trans: torch.Tensor, max_corr_dist: float,
        max_iterations: int = 100, epsilon: float = 1e-4, dtype: torch.dtype = DTYPE) -> ICP:
    """Point-to-point ICP of the valid points of src [N, 3] onto those of
    tgt [M, 3] from (init_rot, init_trans), computed in `dtype`."""
    a = src[src_mask.bool()].to(dtype)
    b = tgt[tgt_mask.bool()].to(dtype)
    rot, trans = init_rot.to(dtype), init_trans.to(dtype)
    gate = max_corr_dist * max_corr_dist
    eye = torch.eye(3, dtype=dtype, device=a.device)
    iterations = 0
    if not a.shape[0] or not b.shape[0]:
        return ICP(rot, trans, float("inf"), 0, iterations)
    for iterations in range(1, max_iterations + 1):
        d2, j = _nearest(a @ rot.T + trans, b)
        near = d2 < gate
        if int(near.sum()) < 3:
            break
        new_rot, new_trans = _kabsch(a[near], b[j[near]])
        step_rot = rot.T @ new_rot
        step_trans = rot.T @ (new_trans - trans)
        moved = max(float((step_rot - eye).abs().max()), float(step_trans.abs().max()))
        rot, trans = new_rot, new_trans
        if moved < epsilon:
            break
    d2, _ = _nearest(a @ rot.T + trans, b)
    return ICP(rot, trans, float(d2.double().mean()), int((d2 < gate).sum()), iterations)


class Factor(NamedTuple):
    rel_rot: torch.Tensor  # [3, 3] float64
    rel_trans: torch.Tensor  # [3]
    variance: float
    fitness: float
    accepted: bool
    pairs: int
    iterations: int


def verify(cur_rot, cur_trans, prev_rot, prev_trans, cur_xyz, cur_mask, prev_xyz, prev_mask,
           init_yaw: float, max_corr_dist: float, fitness_threshold: float,
           dtype: torch.dtype = DTYPE, start=None) -> Factor:
    """ICP of the current keyframe's submap onto the candidate's from the
    yaw `init_yaw` (0 for a radius-search loop), or from the ICP pose
    `start` = (rot, trans) when given, and the between factor of the two
    keyframes' poses that the ICP's correction gives."""
    if start is None:
        c, s = math.cos(float(init_yaw)), math.sin(float(init_yaw))
        start = (torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=DTYPE,
                              device=cur_xyz.device),
                 torch.zeros(3, dtype=DTYPE, device=cur_xyz.device))
    res = icp(cur_xyz, cur_mask, prev_xyz, prev_mask, start[0].to(DTYPE), start[1].to(DTYPE),
              max_corr_dist, dtype=dtype)
    r_icp, t_icp = res.rot.to(DTYPE), res.trans.to(DTYPE)
    # pose_from = icp o T_cur, pose_to = T_prev; the factor is pose_from^-1 o pose_to
    r_from = r_icp @ cur_rot.to(DTYPE)
    t_from = r_icp @ cur_trans.to(DTYPE) + t_icp
    rel_rot = r_from.T @ prev_rot.to(DTYPE)
    rel_trans = r_from.T @ (prev_trans.to(DTYPE) - t_from)
    accepted = res.pairs >= 3 and res.fitness < fitness_threshold
    return Factor(rel_rot, rel_trans, max(res.fitness, 1e-6), res.fitness, accepted, res.pairs,
                  res.iterations)


def icp_pose_of(cur_rot, cur_trans, prev_rot, prev_trans, rel_rot, rel_trans):
    """The ICP pose (rot, trans) that a factor (rel_rot, rel_trans) of the two
    keyframes came from: icp o T_cur = T_prev o rel^-1, so
    icp = T_prev o rel^-1 o T_cur^-1, in float64."""
    cur_rot, cur_trans, prev_rot, prev_trans, rel_rot, rel_trans = (
        t.to(DTYPE) for t in (cur_rot, cur_trans, prev_rot, prev_trans, rel_rot, rel_trans))
    r_from = prev_rot @ rel_rot.T
    t_from = prev_trans - r_from @ rel_trans
    r_icp = r_from @ cur_rot.T
    return r_icp, t_from - r_icp @ cur_trans

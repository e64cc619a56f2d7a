"""Ground-prior observations, the prior queue and the keyframe association
that emits prior between-factors, torch port of `rolo_tpu/prior/association.py`
(prior_pose_node's HandlePose and backMapping's priorInfoHandler /
performPriorAssociation).

`push_prior` writes one ring-buffer row in place (`ops.rows.write_row_`), as
the back-end's other stores do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PriorConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..loop.closure import icp_point2point
from ..ops.rows import write_row_
from ..pointcloud.cloud import PaddedCloud
from ..runtime.platform import default_device
from .ground import GroundMap, extract_patch
from .vehicle import VehicleModel, solve_pose


class PriorObservation(NamedTuple):
    """One solved prior pose and its ground patch."""

    rot: torch.Tensor  # [3, 3] world-frame prior pose (x, y, yaw in; z, roll, pitch solved)
    trans: torch.Tensor  # [3]
    patch_xyz: torch.Tensor  # [Gp, 3]
    patch_mask: torch.Tensor  # [Gp]
    success: torch.Tensor  # [] bool


def compute_prior(gm: GroundMap, vehicle: VehicleModel, x, y, yaw,
                  cfg: PriorConfig = PriorConfig(), patch_capacity: int = 2048
                  ) -> PriorObservation:
    """Solve (z, roll, pitch) at (x, y, yaw), build the pose and cut the
    ground patch around it (association.py:45-67)."""
    res = solve_pose(gm, vehicle, x, y, yaw, cfg)
    dtype, dev = gm.xyz.dtype, gm.xyz.device
    yaw = torch.as_tensor(yaw, dtype=dtype, device=dev)
    trans = torch.stack([torch.as_tensor(x, dtype=dtype, device=dev),
                         torch.as_tensor(y, dtype=dtype, device=dev), res.z])
    patch = extract_patch(gm, trans[:2], cfg.ground_patch_size, patch_capacity)
    return PriorObservation(rot=so3.rpy_to_matrix(res.roll, res.pitch, yaw), trans=trans,
                            patch_xyz=patch.xyz, patch_mask=patch.mask & res.success,
                            success=res.success & patch.mask.any())


class PriorQueue(NamedTuple):
    """Priors stored relative to their linked keyframe (association.py:70-86)."""

    rel_rot: torch.Tensor  # [P, 3, 3]
    rel_trans: torch.Tensor  # [P, 3]
    linked_key: torch.Tensor  # [P] int32
    patch_xyz: torch.Tensor  # [P, Gp, 3]
    patch_mask: torch.Tensor  # [P, Gp]
    valid: torch.Tensor  # [P]
    count: torch.Tensor  # [] int32
    last_time: torch.Tensor  # [] stamp of the last accepted prior

    @property
    def capacity(self) -> int:
        return self.rel_rot.shape[0]


def init_queue(capacity: int, patch_capacity: int, device=None,
               dtype=torch.float32) -> PriorQueue:
    device = default_device() if device is None else device
    return PriorQueue(
        rel_rot=torch.eye(3, dtype=dtype, device=device).repeat(capacity, 1, 1),
        rel_trans=torch.zeros(capacity, 3, dtype=dtype, device=device),
        linked_key=torch.zeros(capacity, dtype=torch.int32, device=device),
        patch_xyz=torch.zeros(capacity, patch_capacity, 3, dtype=dtype, device=device),
        patch_mask=torch.zeros(capacity, patch_capacity, dtype=torch.bool, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
        last_time=torch.tensor(float("-inf"), dtype=dtype, device=device),
    )


def push_prior(q: PriorQueue, obs: PriorObservation, linked_key, linked_rot: torch.Tensor,
               linked_trans: torch.Tensor, enable=True, obs_time=None) -> PriorQueue:
    """Store the prior relative to its linked keyframe's pose; the ring
    buffer overwrites its oldest row at capacity (association.py:102-132).
    A no-op unless `enable` and the observation succeeded. Rows are written
    in place; the returned value carries the new count and time."""
    rel = SE3(linked_rot, linked_trans).inverse().compose(SE3(obs.rot, obs.trans))
    idx = q.count % q.capacity
    ok = torch.as_tensor(enable, device=q.count.device) & obs.success
    write_row_(q.rel_rot, idx, rel.rot, ok)
    write_row_(q.rel_trans, idx, rel.trans, ok)
    write_row_(q.linked_key, idx, linked_key, ok)
    write_row_(q.patch_xyz, idx, obs.patch_xyz, ok)
    write_row_(q.patch_mask, idx, obs.patch_mask, ok)
    write_row_(q.valid, idx, True, ok)
    last_time = q.last_time if obs_time is None else torch.as_tensor(
        obs_time, dtype=q.last_time.dtype, device=q.last_time.device)
    return q._replace(count=q.count + ok.to(torch.int32),
                      last_time=torch.where(ok, last_time, q.last_time))


def _slerp(qa: torch.Tensor, qb: torch.Tensor, t: float) -> torch.Tensor:
    """Quaternion slerp with Eigen's semantics, (w, x, y, z) (association.py:135-147)."""
    dot = torch.sum(qa * qb)
    qb = torch.where(dot < 0, -qb, qb)
    theta = torch.arccos(torch.clamp(torch.abs(dot), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, 1.0, sin_theta)
    wa = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(small, t, torch.sin(t * theta) / safe)
    out = wa * qa + wb * qb
    return out / torch.clamp(torch.linalg.vector_norm(out), min=1e-12)


class PriorFactor(NamedTuple):
    i: torch.Tensor  # linked keyframe
    j: torch.Tensor  # current keyframe
    rel_rot: torch.Tensor  # [3, 3]
    rel_trans: torch.Tensor  # [3]
    noise_var: torch.Tensor  # [6] (rx, ry, rz, tx, ty, tz)
    accepted: torch.Tensor  # bool


def _angdiff(a, b):
    return torch.abs(torch.atan2(torch.sin(a - b), torch.cos(a - b)))


def associate_prior(q_entry_rel_rot: torch.Tensor, q_entry_rel_trans: torch.Tensor,
                    q_entry_linked_key, q_entry_patch: PaddedCloud, q_entry_valid,
                    linked_rot: torch.Tensor, linked_trans: torch.Tensor, current_key,
                    current_rot: torch.Tensor, current_trans: torch.Tensor,
                    ground_now: PaddedCloud, cfg: PriorConfig = PriorConfig(),
                    max_icp_iterations: int = 100, approx_knn: bool = False) -> PriorFactor:
    """One queue entry against the current keyframe (association.py:159-255):
    xy distance gate, patch ICP against the current ground gated on fitness,
    z / roll / pitch consistency between the odometry and the corrected
    prior relative motions, a slerp of roll / pitch toward the prior
    (weight 0.2), and the factor linked -> current with variances (s, s,
    1e-6, 1e-6, 1e-6, s), s = max(fitness, 1e-6) * weight.

    Both relative motions are right differences in the linked keyframe's
    frame, the reference's documented deviation from the left difference of
    backMapping.cpp:2065-2066 (association.py:207-220), kept as it is."""
    dtype, dev = linked_trans.dtype, linked_trans.device
    linked = SE3(linked_rot, linked_trans)
    current = SE3(current_rot, current_trans)
    rel_prior = SE3(q_entry_rel_rot, q_entry_rel_trans)

    global_prior = linked.compose(rel_prior)
    near = torch.linalg.vector_norm(global_prior.trans[:2] - current.trans[:2]) < \
        cfg.near_prior_radius
    icp = icp_point2point(q_entry_patch, ground_now, torch.eye(3, dtype=dtype, device=dev),
                          torch.zeros(3, dtype=dtype, device=dev),
                          max_corr_dist=cfg.ground_patch_size, max_iterations=max_icp_iterations,
                          approx_knn=approx_knn)
    fit_ok = icp.converged & (icp.fitness < cfg.fitness_score)

    odom_rel = linked.inverse().compose(current)
    icp_in_linked = linked.inverse().compose(SE3(icp.rot, icp.trans)).compose(linked)
    prior_rel = icp_in_linked.compose(rel_prior)
    o_roll, o_pitch, o_yaw = so3.matrix_to_rpy(odom_rel.rot)
    p_roll, p_pitch, _ = so3.matrix_to_rpy(prior_rel.rot)
    diff_ok = ((torch.abs(odom_rel.trans[2] - prior_rel.trans[2]) <= cfg.trans_diff_tolerance)
               & (_angdiff(o_roll, p_roll) <= cfg.rot_diff_tolerance_rad)
               & (_angdiff(o_pitch, p_pitch) <= cfg.rot_diff_tolerance_rad))

    # keep odometry yaw and translation; the factor is the blended right
    # difference linked -> current (priorWeight 0.2)
    blended = _slerp(so3.matrix_to_quat(odom_rel.rot),
                     so3.matrix_to_quat(so3.rpy_to_matrix(p_roll, p_pitch, o_yaw)), 0.2)
    s = torch.clamp(icp.fitness, min=1e-6) * cfg.factor_weight
    tight = torch.tensor(1e-6, dtype=dtype, device=dev)
    current_key = torch.as_tensor(current_key, device=dev)
    q_entry_linked_key = torch.as_tensor(q_entry_linked_key, device=dev)
    return PriorFactor(
        i=q_entry_linked_key.to(torch.int32), j=current_key.to(torch.int32),
        rel_rot=so3.quat_to_matrix(blended), rel_trans=odom_rel.trans,
        noise_var=torch.stack([s, s, tight, tight, tight, s]),
        accepted=(torch.as_tensor(q_entry_valid, device=dev) & near & fit_ok & diff_ok
                  & (q_entry_linked_key != current_key)))

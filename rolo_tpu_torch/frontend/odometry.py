"""Front-end scan-to-scan odometry, torch port of
`rolo_tpu/frontend/odometry.py`: forward prediction, rot-GICP against the
previous scan, pose integration, and the jump-detection flag.

`scan_step(state, ...) -> (state, output)` advances one sequence; the state
carries exactly the reference's fields, so `state_from_numpy` can pick up a
sequence that the JAX package started (its OdometryState as numpy arrays)
and `state_to_numpy` can hand one back.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ..config import RegistrationConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..registration.rotgicp import register_features
from ..voxel.knn import estimate_cov6


class OdometryState(NamedTuple):
    pose_rot: torch.Tensor  # [3, 3] accumulated odometry pose
    pose_trans: torch.Tensor  # [3]
    prev_xyz: torch.Tensor  # [N, 3] previous feature cloud
    prev_mask: torch.Tensor  # [N]
    prev_cov: torch.Tensor  # [6, N] sym3 planes
    step_rot: torch.Tensor  # [3, 3] last step transform
    step_trans: torch.Tensor  # [3]
    trans_old: torch.Tensor  # [3]
    last_interval: torch.Tensor  # []
    initialized: torch.Tensor  # [] bool


class OdometryOutput(NamedTuple):
    pose_rot: torch.Tensor
    pose_trans: torch.Tensor
    step_rot: torch.Tensor
    step_trans: torch.Tensor
    rot_error: torch.Tensor
    converged: torch.Tensor
    failure: torch.Tensor


def init_state(capacity: int, device, dtype=torch.float32) -> OdometryState:
    eye = torch.eye(3, dtype=dtype, device=device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)
    ident6 = torch.tensor([1.0, 0, 0, 1.0, 0, 1.0], dtype=dtype, device=device)
    return OdometryState(
        pose_rot=eye, pose_trans=zero3,
        prev_xyz=torch.zeros(capacity, 3, dtype=dtype, device=device),
        prev_mask=torch.zeros(capacity, dtype=torch.bool, device=device),
        prev_cov=ident6[:, None].expand(6, capacity).contiguous(),
        step_rot=eye, step_trans=zero3, trans_old=zero3,
        last_interval=torch.tensor(9999.0, dtype=dtype, device=device),
        initialized=torch.tensor(False, device=device),
    )


def state_from_numpy(arrays: Mapping, device) -> OdometryState:
    """An OdometryState from arrays keyed by field name, such as
    `state_to_numpy`'s output or the JAX package's `OdometryState._asdict()`."""
    return OdometryState(*(torch.as_tensor(np.array(arrays[f]), device=device)
                           for f in OdometryState._fields))


def state_to_numpy(state: OdometryState) -> dict:
    return {f: getattr(state, f).detach().cpu().numpy() for f in OdometryState._fields}


def forward_predict(step_trans, last_interval, interval):
    """stateLinearPropagation: the last step's translation scaled by the
    interval ratio (odometry.py:80-86)."""
    return step_trans * (interval / torch.clamp(last_interval, min=1e-6))


def scan_step(state: OdometryState, new_xyz: torch.Tensor, new_mask: torch.Tensor,
              interval: torch.Tensor, cfg: RegistrationConfig = RegistrationConfig(),
              voxel_capacity: int = 8192,
              k: int = 20) -> Tuple[OdometryState, OdometryOutput]:
    """One front-end step (odometry.py:89-166): register the previous
    features onto this scan's features new_xyz [N, 3] and integrate. The
    jump flag `failure` is computed and returned; the reference's opt-in
    gate that acts on it (enable_failure_gate) is not ported yet."""
    dt = new_xyz.dtype
    interval = torch.as_tensor(interval, dtype=dt, device=new_xyz.device)
    new_cov = estimate_cov6(new_xyz[None], new_mask[None], k=k, method=cfg.regularization)[0]
    guess = forward_predict(state.step_trans, state.last_interval, interval)
    res = register_features(
        state.prev_xyz[None], state.prev_mask[None], state.prev_cov[None],
        new_xyz[None], new_mask[None], new_cov[None],
        guess[None], state.trans_old[None], interval[None], state.last_interval[None],
        cfg, voxel_capacity)
    first = ~state.initialized
    eye = torch.eye(3, dtype=dt, device=new_xyz.device)
    step_rot = torch.where(first, eye, res.rot[0])
    step_trans = torch.where(first, torch.zeros_like(guess), res.trans[0])

    step_inv = SE3(step_rot, step_trans).inverse()
    pose = SE3(state.pose_rot, state.pose_trans).compose(step_inv)
    dt2 = torch.clamp(interval, min=1e-3) ** 2
    d_t = torch.sum(step_inv.trans ** 2)
    d_r = torch.sum(so3.log(step_inv.rot) ** 2)
    failure = ((d_t / dt2 >= 5.0) | (d_r / dt2 >= 0.04)) & ~first

    new_state = OdometryState(
        pose_rot=pose.rot, pose_trans=pose.trans, prev_xyz=new_xyz, prev_mask=new_mask,
        prev_cov=new_cov, step_rot=step_rot, step_trans=step_trans, trans_old=step_trans,
        last_interval=interval, initialized=torch.ones_like(state.initialized))
    out = OdometryOutput(pose.rot, pose.trans, step_rot, step_trans, res.rot_error[0],
                         res.converged[0], failure)
    return new_state, out


def run_sequence(feats_xyz: torch.Tensor, feats_mask: torch.Tensor, intervals: torch.Tensor,
                 cfg: RegistrationConfig = RegistrationConfig(), voxel_capacity: int = 8192,
                 k: int = 20) -> OdometryOutput:
    """Odometry over a sequence: feats_xyz [T, N, 3], feats_mask [T, N],
    intervals [T] -> per-scan outputs stacked along T."""
    state = init_state(feats_xyz.shape[1], feats_xyz.device, feats_xyz.dtype)
    outs = []
    for i in range(feats_xyz.shape[0]):
        state, out = scan_step(state, feats_xyz[i], feats_mask[i], intervals[i], cfg,
                               voxel_capacity, k)
        outs.append(out)
    return OdometryOutput(*(torch.stack(f) for f in zip(*outs)))

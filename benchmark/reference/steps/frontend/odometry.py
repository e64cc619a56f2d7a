"""Frozen copy of `rolo_tpu_torch/frontend/odometry.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

Front-end scan-to-scan odometry, torch port of
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
from ..ops.linalg import small_matmul
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


def init_state(capacity: int, device, dtype=torch.float32, batch: int = None) -> OdometryState:
    """A fresh state; with `batch`, B of them stacked along a leading dim."""
    eye = torch.eye(3, dtype=dtype, device=device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)
    ident6 = torch.tensor([1.0, 0, 0, 1.0, 0, 1.0], dtype=dtype, device=device)
    state = OdometryState(
        pose_rot=eye, pose_trans=zero3,
        prev_xyz=torch.zeros(capacity, 3, dtype=dtype, device=device),
        prev_mask=torch.zeros(capacity, dtype=torch.bool, device=device),
        prev_cov=ident6[:, None].expand(6, capacity).contiguous(),
        step_rot=eye, step_trans=zero3, trans_old=zero3,
        last_interval=torch.tensor(9999.0, dtype=dtype, device=device),
        initialized=torch.tensor(False, device=device),
    )
    if batch is None:
        return state
    return OdometryState(*(t.expand(batch, *t.shape).contiguous() for t in state))


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
              interval, cfg: RegistrationConfig = RegistrationConfig(),
              voxel_capacity: int = 8192, k: int = 20,
              enable_failure_gate: bool = False) -> Tuple[OdometryState, OdometryOutput]:
    """One front-end step (odometry.py:89-166): register the previous
    features onto this scan's features and integrate. new_xyz [N, 3] with an
    unbatched state, or [B, N, 3] with a state of B sequences (fields lead
    with [B], `interval` a scalar or [B]): the reference's vmap over
    sequences. The jump flag `failure` is always computed and returned; with
    `enable_failure_gate` a flagged step is rejected: the pose holds and the
    step is zeroed, so the next forward prediction does not re-seed from the
    jump (odometry.py:133-143)."""
    if new_xyz.dim() == 2:
        st, out = scan_step(OdometryState(*(t[None] for t in state)), new_xyz[None],
                            new_mask[None], interval, cfg, voxel_capacity, k,
                            enable_failure_gate)
        return OdometryState(*(t[0] for t in st)), OdometryOutput(*(t[0] for t in out))
    bsz = new_xyz.shape[0]
    dt, dev = new_xyz.dtype, new_xyz.device
    interval = torch.as_tensor(interval, dtype=dt, device=dev).expand(bsz)
    new_cov = estimate_cov6(new_xyz, new_mask, k=k, method=cfg.regularization)
    guess = forward_predict(state.step_trans, state.last_interval[:, None], interval[:, None])
    res = register_features(state.prev_xyz, state.prev_mask, state.prev_cov, new_xyz, new_mask,
                            new_cov, guess, state.trans_old, interval, state.last_interval, cfg,
                            voxel_capacity)
    first = ~state.initialized
    eye = torch.eye(3, dtype=dt, device=dev)
    step_rot = torch.where(first[:, None, None], eye, res.rot)
    step_trans = torch.where(first[:, None], torch.zeros_like(guess), res.trans)

    # pose @ step^-1, as SE3.inverse / compose with batch-invariant products
    step_inv = SE3(step_rot.transpose(1, 2),
                   -small_matmul(step_rot.transpose(1, 2), step_trans[..., None])[..., 0])
    pose = SE3(small_matmul(state.pose_rot, step_inv.rot),
               small_matmul(state.pose_rot, step_inv.trans[..., None])[..., 0] + state.pose_trans)
    dt2 = torch.clamp(interval, min=1e-3) ** 2
    d_t = torch.sum(step_inv.trans ** 2, dim=-1)
    d_r = torch.sum(so3.log(step_inv.rot) ** 2, dim=-1)
    failure = ((d_t / dt2 >= 5.0) | (d_r / dt2 >= 0.04)) & ~first
    if enable_failure_gate:
        pose = SE3(torch.where(failure[:, None, None], state.pose_rot, pose.rot),
                   torch.where(failure[:, None], state.pose_trans, pose.trans))
        step_rot = torch.where(failure[:, None, None], eye, step_rot)
        step_trans = torch.where(failure[:, None], torch.zeros_like(step_trans), step_trans)

    new_state = OdometryState(
        pose_rot=pose.rot, pose_trans=pose.trans, prev_xyz=new_xyz, prev_mask=new_mask,
        prev_cov=new_cov, step_rot=step_rot, step_trans=step_trans, trans_old=step_trans,
        last_interval=interval, initialized=torch.ones_like(state.initialized))
    out = OdometryOutput(pose.rot, pose.trans, step_rot, step_trans, res.rot_error,
                         res.converged, failure)
    return new_state, out


def run_sequence(feats_xyz: torch.Tensor, feats_mask: torch.Tensor, intervals: torch.Tensor,
                 cfg: RegistrationConfig = RegistrationConfig(), voxel_capacity: int = 8192,
                 k: int = 20) -> OdometryOutput:
    """Odometry over a sequence: feats_xyz [T, N, 3], feats_mask [T, N],
    intervals [T] -> per-scan outputs stacked along T. With a leading [B]
    on all three (B sequences of T scans), outputs are [B, T, ...]."""
    if feats_xyz.dim() == 3:
        out = run_sequence(feats_xyz[None], feats_mask[None], intervals[None], cfg,
                           voxel_capacity, k)
        return OdometryOutput(*(t[0] for t in out))
    bsz, steps, n = feats_xyz.shape[:3]
    state = init_state(n, feats_xyz.device, feats_xyz.dtype, batch=bsz)
    outs = []
    for i in range(steps):
        state, out = scan_step(state, feats_xyz[:, i], feats_mask[:, i], intervals[:, i], cfg,
                               voxel_capacity, k)
        outs.append(out)
    return OdometryOutput(*(torch.stack(f, dim=1) for f in zip(*outs)))

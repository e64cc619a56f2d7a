"""Odometry fusion, torch port of `rolo_tpu/filter/fusion.py` (the
reference's TransformFusion): the front-end odometry feeds the pose ESKF,
each mapping pose is recorded with the front-end pose of its scan, and the
fused pose is mapping o (front_anchor^-1 o filtered_now); plus the
future-pose rollout the prior stack reads.

`fusion_state_to_numpy` / `fusion_state_from_numpy` move a FusionState
(with its nested ESKFState) between this package and the JAX package.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from ..config import FilterConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..ops.pytree import tree_from_numpy, tree_to_numpy
from ..ops.rows import read_row
from ..runtime.platform import default_device
from . import eskf


class FusionState(NamedTuple):
    filter: eskf.ESKFState
    front_rot: torch.Tensor  # [3, 3] front-end pose at the latest mapping update
    front_trans: torch.Tensor  # [3]
    mapping_rot: torch.Tensor  # [3, 3] latest mapping pose
    mapping_trans: torch.Tensor  # [3]
    has_mapping: torch.Tensor  # [] bool


def init_fusion(cfg: FilterConfig = FilterConfig(), device=None,
                dtype=torch.float32) -> FusionState:
    device = default_device() if device is None else device
    eye = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros(3, dtype=dtype, device=device)
    return FusionState(filter=eskf.init_filter(cfg, device, dtype), front_rot=eye,
                       front_trans=zero, mapping_rot=eye, mapping_trans=zero,
                       has_mapping=torch.tensor(False, device=device))


def on_front_odometry(state: FusionState, stamp, rot: torch.Tensor, trans: torch.Tensor,
                      cfg: FilterConfig = FilterConfig()) -> Tuple[FusionState, torch.Tensor]:
    """Feed one front-end odometry pose into the filter (fusion.py:49-60)."""
    f, ok = eskf.process_measurement(state.filter, stamp, trans, rot, cfg)
    return state._replace(filter=f), ok


def on_mapping_odometry(state: FusionState, mapping_rot: torch.Tensor,
                        mapping_trans: torch.Tensor, front_rot: torch.Tensor,
                        front_trans: torch.Tensor) -> FusionState:
    """Record a mapping pose and the front-end pose of the same scan
    (fusion.py:63-79)."""
    return state._replace(mapping_rot=mapping_rot, mapping_trans=mapping_trans,
                          front_rot=front_rot, front_trans=front_trans,
                          has_mapping=torch.ones_like(state.has_mapping))


class FusedPose(NamedTuple):
    rot: torch.Tensor  # [3, 3]
    trans: torch.Tensor  # [3]
    velocity: torch.Tensor  # [3]
    speed: torch.Tensor  # []
    valid: torch.Tensor  # [] bool


def fused_pose(state: FusionState, stamp, cfg: FilterConfig = FilterConfig()) -> FusedPose:
    """Dead-reckon a copy of the filter to `stamp` and compose
    mapping o (front_anchor^-1 o filtered_now) (fusion.py:90-113); the
    filter itself is not advanced."""
    preview, _ = eskf.state_predict(state.filter, stamp, cfg)
    incre = SE3(state.front_rot, state.front_trans).inverse().compose(
        SE3(preview.rot, preview.pos))
    fused = SE3(state.mapping_rot, state.mapping_trans).compose(incre)
    return FusedPose(rot=fused.rot, trans=fused.trans, velocity=preview.vel,
                     speed=torch.linalg.vector_norm(preview.vel),
                     valid=state.has_mapping & state.filter.initialized)


class FuturePrediction(NamedTuple):
    """The future path in the current lidar frame (z zeroed) and its final
    pose, which the prior stack reads."""

    local_pos: torch.Tensor  # [M, 3]
    local_quat: torch.Tensor  # [M, 4] (w, x, y, z)
    mask: torch.Tensor  # [M]
    final_pos: torch.Tensor  # [3] last valid local pose
    final_quat: torch.Tensor  # [4]
    local_velocity: torch.Tensor  # [3]
    heading_rate: torch.Tensor  # []
    valid: torch.Tensor  # [] bool


def predict_future(state: FusionState, cfg: FilterConfig = FilterConfig()) -> FuturePrediction:
    """Roll the filter mean forward and express every future pose relative
    to the current filter pose (fusion.py:131-159)."""
    f = state.filter
    roll = eskf.state_propagate(f, cfg)
    cur_inv = SE3(f.rot, f.pos).inverse()
    local = cur_inv.compose(SE3(so3.quat_to_matrix(roll.quat), roll.pos))
    local_quat = so3.matrix_to_quat(local.rot)
    local_pos = torch.cat([local.trans[:, :2], torch.zeros_like(local.trans[:, 2:])], dim=1)
    fi = roll.final_index
    return FuturePrediction(
        local_pos=local_pos, local_quat=local_quat, mask=roll.mask,
        final_pos=read_row(local_pos, fi), final_quat=read_row(local_quat, fi),
        local_velocity=f.rot.T @ f.vel, heading_rate=f.omega[2],
        valid=f.initialized & torch.any(roll.mask))


def fusion_state_to_numpy(state) -> dict:
    """A FusionState (this package's or the JAX package's) as numpy arrays
    keyed by field path ("filter.cov", "front_rot", ...)."""
    return tree_to_numpy(state)


def fusion_state_from_numpy(arrays: Mapping, device) -> FusionState:
    """A FusionState on `device` from `fusion_state_to_numpy`'s layout."""
    return tree_from_numpy(FusionState, arrays, device)

"""Batched entry points over a process group: registrations, odometry
sequences and prior solves, the counterpart of `rolo_tpu/parallel/batch.py`.

The reference jits a vmap over a batch that a mesh shards. Here every rank
calls these functions on its own slice of the batch (`shard_batch`,
`shard_registration_inputs`); each is one batched call of the port's
masked loops, so no collective runs inside them, and `group_mean` reduces a
summary statistic over the group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import PriorConfig, RegistrationConfig
from ..frontend.odometry import OdometryOutput, run_sequence
from ..prior.ground import GroundMap
from ..prior.vehicle import SolverResult, VehicleModel, solve_pose
from ..registration.rotgicp import ScanPairResult, register_scan_pair
from .mesh import shard_batch


def registration_batch(src_xyz, src_mask, tgt_xyz, tgt_mask, init_translation,
                       last_translation, interval_tn, interval_tn_1,
                       cfg: RegistrationConfig = RegistrationConfig(), voxel_capacity: int = 8192,
                       k: int = 20) -> ScanPairResult:
    """rot-GICP scan-pair registration of this rank's pairs (batch.py:31-52):
    clouds [B, N, 3], masks [B, N], translations [B, 3], intervals [B]."""
    return register_scan_pair(src_xyz, src_mask, tgt_xyz, tgt_mask, init_translation,
                              last_translation, interval_tn, interval_tn_1, cfg, voxel_capacity, k)


def odometry_batch(feats_xyz, feats_mask, intervals, cfg: RegistrationConfig = RegistrationConfig(),
                   voxel_capacity: int = 8192, k: int = 20) -> OdometryOutput:
    """Front-end odometry over this rank's sequences (batch.py:55-70):
    feats_xyz [B, T, N, 3], feats_mask [B, T, N], intervals [B, T] ->
    outputs [B, T, ...], one batched scan_step per time step."""
    return run_sequence(feats_xyz, feats_mask, intervals, cfg, voxel_capacity, k)


def prior_solve_batch(gm: GroundMap, vehicle: VehicleModel, x, y, yaw,
                      cfg: PriorConfig = PriorConfig()) -> SolverResult:
    """Wheel-contact pose solves of this rank's [B] queries against one
    shared ground map (batch.py:73-84)."""
    return solve_pose(gm, vehicle, x, y, yaw, cfg)


def group_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of every rank's values x [b] over the group (one all-reduce
    of the sum and the count); x's own mean without a group."""
    sums = torch.stack([x.sum(), torch.tensor(float(x.numel()), dtype=x.dtype,
                                              device=x.device)])
    if dist.is_initialized():
        dist.all_reduce(sums, group=group)
    return sums[0] / sums[1]


class ShardedRegistrationInputs(NamedTuple):
    src_xyz: torch.Tensor
    src_mask: torch.Tensor
    tgt_xyz: torch.Tensor
    tgt_mask: torch.Tensor
    init_translation: torch.Tensor
    last_translation: torch.Tensor
    interval_tn: torch.Tensor
    interval_tn_1: torch.Tensor


def shard_registration_inputs(mesh, src_xyz, src_mask, tgt_xyz, tgt_mask,
                              init_translation=None, last_translation=None,
                              interval: float = 0.1,
                              axis_name="batch") -> ShardedRegistrationInputs:
    """This rank's slice of a registration batch (batch.py:98-121): zero
    translations and a constant interval where none are given."""
    b = src_xyz.shape[0]
    dtype, dev = src_xyz.dtype, src_xyz.device
    if init_translation is None:
        init_translation = torch.zeros(b, 3, dtype=dtype, device=dev)
    if last_translation is None:
        last_translation = torch.zeros(b, 3, dtype=dtype, device=dev)
    dt = torch.full((b,), interval, dtype=dtype, device=dev)
    tree = ShardedRegistrationInputs(src_xyz, src_mask, tgt_xyz, tgt_mask, init_translation,
                                     last_translation, dt, dt)
    return shard_batch(tree, mesh, axis_name)

"""Parallelism over a torch.distributed process group (counterpart of
rolo_tpu/parallel): device meshes and batch slices, batched registrations,
odometry sequences and prior solves, and point-axis SPMD registration."""

from .batch import (
    ShardedRegistrationInputs,
    odometry_batch,
    prior_solve_batch,
    registration_batch,
    shard_registration_inputs,
)
from .mesh import (
    batch_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from .spmd import register_scan_pair_spmd

__all__ = [
    "register_scan_pair_spmd",
    "ShardedRegistrationInputs",
    "odometry_batch",
    "prior_solve_batch",
    "registration_batch",
    "shard_registration_inputs",
    "batch_sharding",
    "make_mesh",
    "pad_to_multiple",
    "replicated",
    "shard_batch",
]

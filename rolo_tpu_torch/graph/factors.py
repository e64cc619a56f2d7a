"""Pose-graph factor containers (fixed-capacity, masked), torch port of
`rolo_tpu/graph/factors.py`: the odometry chain, the first-pose prior, and
between-factor stores for loop closures and ground priors, as parallel
arrays. Noise is per-factor diagonal variances in tangent order (rx, ry, rz,
tx, ty, tz); robust_c > 0 marks a Cauchy kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.rows import write_row_
from ..runtime.platform import default_device

# factors.py:20-28: the reference's first-pose prior variances, the anchored
# variant the batch re-solve uses (a pure gauge choice), and the odometry noise
FIRST_PRIOR_VARIANCES_REFERENCE = (1e-2, 1e-2, 9.8696044, 1e8, 1e8, 1e8)
FIRST_PRIOR_VARIANCES = (1e-6, 1e-6, 1e-6, 1e-6, 1e-6, 1e-6)
ODOM_VARIANCES = (1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4)


class BetweenFactors(NamedTuple):
    """Fixed-capacity between-factor set: T_i^{-1} T_j should equal Z."""

    i: torch.Tensor  # [L] int32
    j: torch.Tensor  # [L] int32
    rel_rot: torch.Tensor  # [L, 3, 3]
    rel_trans: torch.Tensor  # [L, 3]
    noise_var: torch.Tensor  # [L, 6]
    robust_c: torch.Tensor  # [L] Cauchy k (0 = gaussian)
    valid: torch.Tensor  # [L] bool
    count: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.i.shape[0]


def empty_between(capacity: int, device=None, dtype=torch.float32) -> BetweenFactors:
    device = default_device() if device is None else device
    return BetweenFactors(
        i=torch.zeros(capacity, dtype=torch.int32, device=device),
        j=torch.zeros(capacity, dtype=torch.int32, device=device),
        rel_rot=torch.eye(3, dtype=dtype, device=device).repeat(capacity, 1, 1),
        rel_trans=torch.zeros(capacity, 3, dtype=dtype, device=device),
        noise_var=torch.ones(capacity, 6, dtype=dtype, device=device),
        robust_c=torch.zeros(capacity, dtype=dtype, device=device),
        valid=torch.zeros(capacity, dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_between(f: BetweenFactors, i, j, rel_rot: torch.Tensor, rel_trans: torch.Tensor,
                noise_var: torch.Tensor, robust_c=None, enable=True) -> BetweenFactors:
    """Append one factor (factors.py:61-88); a no-op when `enable` is false
    or the store is full. The store's arrays are written in place; the
    returned value carries the new count."""
    idx = torch.clamp(f.count, max=f.capacity - 1)
    ok = torch.as_tensor(enable, device=f.count.device) & (f.count < f.capacity)
    write_row_(f.i, idx, i, ok)
    write_row_(f.j, idx, j, ok)
    write_row_(f.rel_rot, idx, rel_rot, ok)
    write_row_(f.rel_trans, idx, rel_trans, ok)
    write_row_(f.noise_var, idx, noise_var, ok)
    write_row_(f.robust_c, idx, 0.0 if robust_c is None else robust_c, ok)
    write_row_(f.valid, idx, True, ok)
    return f._replace(count=f.count + ok.to(torch.int32))


class PoseGraph(NamedTuple):
    """The back-end's factor graph: odom_rel_{k} constrains pose k-1 -> k for
    1 <= k < count; first_* is the prior on pose 0."""

    odom_rel_rot: torch.Tensor  # [K, 3, 3]
    odom_rel_trans: torch.Tensor  # [K, 3]
    first_rot: torch.Tensor  # [3, 3]
    first_trans: torch.Tensor  # [3]
    loops: BetweenFactors
    priors: BetweenFactors


def empty_graph(max_keyframes: int, max_loops: int, max_priors: int, device=None,
                dtype=torch.float32) -> PoseGraph:
    device = default_device() if device is None else device
    return PoseGraph(
        odom_rel_rot=torch.eye(3, dtype=dtype, device=device).repeat(max_keyframes, 1, 1),
        odom_rel_trans=torch.zeros(max_keyframes, 3, dtype=dtype, device=device),
        first_rot=torch.eye(3, dtype=dtype, device=device),
        first_trans=torch.zeros(3, dtype=dtype, device=device),
        loops=empty_between(max_loops, device, dtype),
        priors=empty_between(max_priors, device, dtype),
    )

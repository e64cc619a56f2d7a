"""Ground-prior queue state, torch port of the queue half of
`rolo_tpu/prior/association.py`: the fixed-capacity store of priors kept
relative to their linked keyframes, which `BackendState` carries. Computing,
pushing and associating priors belong to the prior slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PriorQueue(NamedTuple):
    """priorPosePatchHistory + priorTimeKeyQueue (association.py:70-86)."""

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

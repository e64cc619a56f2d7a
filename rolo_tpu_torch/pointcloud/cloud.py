"""Fixed-capacity padded point clouds, torch port of
`rolo_tpu/pointcloud/cloud.py`."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..runtime.platform import default_device


class PaddedCloud(NamedTuple):
    """xyz [..., N, 3] float32, mask [..., N] bool (True = real point)."""

    xyz: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)

    @staticmethod
    def from_points(points, capacity: int, device=None) -> "PaddedCloud":
        """From a dense [M, 3] host array, truncated to `capacity`, on
        `device` (the card when None)."""
        device = default_device() if device is None else device
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        m = min(points.shape[0], capacity)
        xyz = np.zeros((capacity, 3), dtype=np.float32)
        xyz[:m] = points[:m]
        mask = np.zeros((capacity,), dtype=bool)
        mask[:m] = True
        return PaddedCloud(torch.as_tensor(xyz, device=device), torch.as_tensor(mask, device=device))

    def to_numpy(self) -> np.ndarray:
        """The valid points as a dense host array."""
        return self.xyz.detach().cpu().numpy()[self.mask.detach().cpu().numpy()]

    def transformed(self, rot: torch.Tensor, trans: torch.Tensor) -> "PaddedCloud":
        return PaddedCloud(self.xyz @ rot.transpose(-1, -2) + trans[..., None, :], self.mask)


def concat_clouds(a: PaddedCloud, b: PaddedCloud, capacity: Optional[int] = None) -> PaddedCloud:
    """Stack two padded clouds; when `capacity` is smaller than the sum, the
    valid points move first (stable) and the overflow is cut
    (cloud.py:52-71)."""
    xyz = torch.cat([a.xyz, b.xyz], dim=-2)
    mask = torch.cat([a.mask, b.mask], dim=-1)
    n = xyz.shape[-2]
    if capacity is not None and capacity != n:
        if capacity < n:
            c = compact_cloud(PaddedCloud(xyz, mask))
            xyz, mask = c.xyz[..., :capacity, :], c.mask[..., :capacity]
        else:
            pad = capacity - n
            xyz = torch.cat([xyz, xyz.new_zeros(*xyz.shape[:-2], pad, 3)], dim=-2)
            mask = torch.cat([mask, mask.new_zeros(*mask.shape[:-1], pad)], dim=-1)
    return PaddedCloud(xyz, mask)


def compact_cloud(cloud: PaddedCloud) -> PaddedCloud:
    """Move valid points to the front (stable), padding to the back
    (cloud.py:74-79)."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), dim=-1, stable=True)
    xyz = torch.gather(cloud.xyz, -2, order[..., None].expand(*order.shape, 3))
    return PaddedCloud(xyz, torch.gather(cloud.mask, -1, order))

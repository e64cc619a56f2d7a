"""Fixed-capacity padded point clouds, torch port of
`rolo_tpu/pointcloud/cloud.py`."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PaddedCloud(NamedTuple):
    """xyz [..., N, 3] float32, mask [..., N] bool (True = real point)."""

    xyz: torch.Tensor
    mask: torch.Tensor


def concat_clouds(a: PaddedCloud, b: PaddedCloud, capacity: Optional[int] = None) -> PaddedCloud:
    """Stack two padded clouds; when `capacity` is smaller than the sum, the
    valid points move first (stable) and the overflow is cut
    (cloud.py:52-71)."""
    xyz = torch.cat([a.xyz, b.xyz], dim=-2)
    mask = torch.cat([a.mask, b.mask], dim=-1)
    n = xyz.shape[-2]
    if capacity is not None and capacity != n:
        if capacity < n:
            order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
            xyz = torch.gather(xyz, -2, order[..., None].expand(*order.shape, 3))[..., :capacity, :]
            mask = torch.gather(mask, -1, order)[..., :capacity]
        else:
            pad = capacity - n
            xyz = torch.cat([xyz, xyz.new_zeros(*xyz.shape[:-2], pad, 3)], dim=-2)
            mask = torch.cat([mask, mask.new_zeros(*mask.shape[:-1], pad)], dim=-1)
    return PaddedCloud(xyz, mask)

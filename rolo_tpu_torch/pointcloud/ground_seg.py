"""Live ground segmentation from the projected scan, torch port of
`rolo_tpu/pointcloud/ground_seg.py`: LeGO-LOAM-style inter-ring slope
marking over the dense range image, the in-repo source of the ground map
the prior stack reads.

One deliberate difference: only the valid slots of the per-ring compacted
image are scattered back to the dense grid. The reference scatters every
slot, padding included at column 0, so where a ring has padding its
column-0 return is overwritten by a zero point that the `.max` scatter of
the mask keeps valid; each such ring then emits a ground point at the sensor
origin. Here column 0 holds the real return.
"""

from __future__ import annotations

import math

import torch

from .cloud import PaddedCloud
from .projection import RingImage


def segment_ground(img: RingImage, horizon: int, ground_rings: int, slope_deg: float = 10.0,
                   out_capacity: int = 8192) -> PaddedCloud:
    """Ground points of one scan in the sensor frame (ground_seg.py:26-74):
    a segment between vertically adjacent returns is ground when its slope
    is below `slope_deg`, both endpoints are marked, and only the lowest
    `ground_rings` rings are eligible. Compacted valid-first in grid order."""
    r, h = img.mask.shape
    dev = img.xyz.device
    n_pix = r * horizon
    ring_id = torch.arange(r, device=dev)[:, None].expand(r, h)
    # invalid slots all land in one spare pixel past the grid
    flat_idx = torch.where(img.mask, ring_id * horizon + img.col.long(), n_pix).reshape(-1)
    dense_xyz = img.xyz.new_zeros(n_pix + 1, 3).index_put_((flat_idx,), img.xyz.reshape(-1, 3))
    dense_ok = torch.zeros(n_pix + 1, dtype=torch.bool, device=dev).index_put_(
        (flat_idx,), img.mask.reshape(-1))
    dense_xyz = dense_xyz[:n_pix].reshape(r, horizon, 3)
    dense_ok = dense_ok[:n_pix].reshape(r, horizon)

    d = dense_xyz[1:] - dense_xyz[:-1]  # ring b+1 minus ring b
    slope = torch.atan2(torch.abs(d[..., 2]), torch.linalg.vector_norm(d[..., :2], dim=-1) + 1e-9)
    eligible = torch.arange(r - 1, device=dev)[:, None] < ground_rings
    flat = dense_ok[:-1] & dense_ok[1:] & (slope < math.radians(slope_deg)) & eligible

    gmask = torch.zeros(r, horizon, dtype=torch.bool, device=dev)
    gmask[:-1] = flat
    gmask[1:] |= flat
    flat_mask = (gmask & dense_ok).reshape(-1)
    take = torch.argsort((~flat_mask).to(torch.uint8), stable=True)[:out_capacity]
    return PaddedCloud(dense_xyz.reshape(-1, 3)[take], flat_mask[take])

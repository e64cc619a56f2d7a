"""Range-image projection with motion deskew, torch port of
`rolo_tpu/pointcloud/projection.py`.

A raw scan becomes a dense [n_scan, horizon] image by a first-return-wins
scatter-min over point indices, then per-ring compacted arrays in column
order (RingImage) that feature extraction consumes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..geometry import so3


class RawScan(NamedTuple):
    """xyz [N, 3]; ring [N] int32; rel_time [N] f32 (s since sweep start);
    mask [N] bool."""

    xyz: torch.Tensor
    ring: torch.Tensor
    rel_time: torch.Tensor
    mask: torch.Tensor


class RingImage(NamedTuple):
    """Per-ring compacted scan, each [R, H] (xyz [R, H, 3]); count [R]."""

    xyz: torch.Tensor
    rng: torch.Tensor
    col: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor


def project_scan(scan: RawScan, n_scan: int, horizon: int, min_range: float, max_range: float,
                 downsample_rate: int = 1, deskew_rpy: Optional[torch.Tensor] = None,
                 odom_time_diff: Optional[torch.Tensor] = None,
                 deskew_vel: Optional[torch.Tensor] = None) -> RingImage:
    """Project a raw scan into a per-ring compacted range image
    (projection.py:53-140). deskew_rpy [3] / odom_time_diff [] rotate each
    point by -rpy * rel_time / odom_time_diff; deskew_vel [3] adds the
    translational correction."""
    xyz = scan.xyz
    n = xyz.shape[0]
    dev = xyz.device
    rng = torch.linalg.vector_norm(xyz, dim=-1)
    valid = scan.mask & (rng >= min_range) & (rng <= max_range)
    valid &= (scan.ring >= 0) & (scan.ring < n_scan)
    if downsample_rate > 1:
        valid &= (scan.ring % downsample_rate) == 0

    ang_res = 360.0 / float(horizon)
    horizon_angle = torch.atan2(xyz[:, 0], xyz[:, 1]) * (180.0 / math.pi)
    col = (-torch.round((horizon_angle - 90.0) / ang_res)).to(torch.int32) + horizon // 2
    col = torch.where(col >= horizon, col - horizon, col)
    valid &= (col >= 0) & (col < horizon)

    if deskew_rpy is not None:
        ratio = scan.rel_time / torch.clamp(odom_time_diff, min=1e-6)
        rpy = -deskew_rpy[None, :] * ratio[:, None]
        rot = so3.rpy_to_matrix(rpy[:, 0], rpy[:, 1], rpy[:, 2])  # [N, 3, 3]
        xyz = (rot @ xyz[:, :, None])[:, :, 0]
        if deskew_vel is not None:
            xyz = xyz + ratio[:, None] * deskew_vel[None, :]

    # First return wins: the smallest point index per pixel.
    npix = n_scan * horizon
    pix = torch.where(valid, scan.ring.to(torch.int64) * horizon + col, npix)
    winner = torch.full((npix + 1,), n, dtype=torch.int64, device=dev)
    winner.scatter_reduce_(0, pix, torch.arange(n, device=dev), reduce="amin")
    winner = winner[:npix]
    pix_valid = winner < n
    widx = torch.clamp(winner, max=n - 1)
    img_xyz = torch.where(pix_valid[:, None], xyz[widx], 0.0).reshape(n_scan, horizon, 3)
    img_rng = torch.where(pix_valid, rng[widx], float("inf")).reshape(n_scan, horizon)
    pix_valid = pix_valid.reshape(n_scan, horizon)

    # Per-ring compaction in column order: a valid pixel's slot is its rank.
    order = torch.cumsum(pix_valid.to(torch.int64), dim=1) - 1
    count = pix_valid.sum(dim=1).to(torch.int32)
    dest = torch.where(pix_valid, order, horizon)
    ridx = torch.arange(n_scan, device=dev)[:, None].expand(n_scan, horizon)
    cols = torch.arange(horizon, dtype=torch.int32, device=dev)[None, :].expand(n_scan, horizon)

    def ring_scatter(values, fill):
        out = torch.full((n_scan, horizon + 1) + values.shape[2:], fill, dtype=values.dtype,
                         device=dev)
        out.index_put_((ridx, dest), values)
        return out[:, :horizon]

    c_xyz = ring_scatter(img_xyz, 0.0)
    c_rng = ring_scatter(torch.where(pix_valid, img_rng, 0.0), 0.0)
    c_col = ring_scatter(cols, 0)
    c_mask = torch.arange(horizon, device=dev)[None, :] < count[:, None]
    return RingImage(c_xyz, c_rng, c_col, c_mask, count)

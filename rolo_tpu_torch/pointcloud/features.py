"""LOAM feature extraction over per-ring compacted scans, torch port of
`rolo_tpu/pointcloud/features.py`.

Corners: 20 rounds of masked argmax over every (ring, sector) at once with
neighbour suppression. Surfaces: every in-sector non-corner point, per-ring
voxel-grid downsampled (sort by an int32 hash, segment means).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..voxel.voxelmap import hash_coord
from .cloud import PaddedCloud
from .projection import RingImage

_NUM_SECTORS = 6
_MAX_CORNERS_PER_SECTOR = 20


class FeatureClouds(NamedTuple):
    corners: PaddedCloud
    surfaces: PaddedCloud


def calculate_smoothness(rng: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """11-tap LOAM curvature over [R, H] ranges (features.py:41-50)."""
    h = rng.shape[1]
    acc = -10.0 * rng
    for off in range(1, 6):
        acc = acc + torch.roll(rng, off, dims=1) + torch.roll(rng, -off, dims=1)
    idx = torch.arange(h, device=rng.device)[None, :]
    interior = (idx >= 5) & (idx < count[:, None] - 5)
    return torch.where(interior, acc * acc, 0.0)


def mark_occluded(rng: torch.Tensor, col: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Occluded + parallel-beam mask (features.py:53-80): True = excluded."""
    h = rng.shape[1]
    idx = torch.arange(h, device=rng.device)[None, :]
    in_pair = (idx >= 5) & (idx < count[:, None] - 6)
    nxt = torch.roll(rng, -1, dims=1)
    col_diff_small = torch.abs(torch.roll(col, -1, dims=1) - col) < 10
    occ_back = in_pair & col_diff_small & ((rng - nxt) > 0.3)
    occ_fwd = in_pair & col_diff_small & ((nxt - rng) > 0.3)
    picked = torch.zeros_like(rng, dtype=torch.bool)
    for off in range(0, 6):
        picked |= torch.roll(occ_back, -off, dims=1)
    for off in range(1, 7):
        picked |= torch.roll(occ_fwd, off, dims=1)
    prv = torch.roll(rng, 1, dims=1)
    parallel = in_pair & (torch.abs(prv - rng) > 0.02 * rng) & (torch.abs(nxt - rng) > 0.02 * rng)
    return picked | parallel


def _sector_bounds(count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ring sector spans sp, ep [R, 6] (features.py:83-95), floor division."""
    start = torch.full_like(count, 4)[:, None]
    end = (count - 6)[:, None]
    j = torch.arange(_NUM_SECTORS, device=count.device, dtype=count.dtype)[None, :]
    sp = torch.div(start * (6 - j) + end * j, 6, rounding_mode="floor")
    ep = torch.div(start * (5 - j) + end * (j + 1), 6, rounding_mode="floor") - 1
    return sp, ep


def _suppress_neighbors(picked, sel, col):
    """Mark +-5 neighbours of fresh picks, stopping at column gaps > 10."""
    col_gap_fwd = torch.abs(col - torch.roll(col, 1, dims=1)) > 10
    run_fwd = sel
    for _ in range(5):
        run_fwd = torch.roll(run_fwd, 1, dims=1) & ~col_gap_fwd
        picked = picked | run_fwd
    run_bwd = sel
    col_gap_bwd = torch.roll(col_gap_fwd, -1, dims=1)
    for _ in range(5):
        run_bwd = torch.roll(run_bwd, -1, dims=1) & ~col_gap_bwd
        picked = picked | run_bwd
    return picked


def extract_features(ring: RingImage, edge_threshold: float, surf_threshold: float,
                     surf_leaf_size: float, max_corners: int, max_surfs: int) -> FeatureClouds:
    """Feature extraction for one scan (features.py:115-161)."""
    r, h = ring.rng.shape
    dev = ring.rng.device
    smooth = calculate_smoothness(ring.rng, ring.count)
    picked = mark_occluded(ring.rng, ring.col, ring.count) | ~ring.mask

    sp, ep = _sector_bounds(ring.count)
    idx = torch.arange(h, device=dev)[None, :, None]
    in_sector = (idx >= sp[:, None, :]) & (idx <= ep[:, None, :])  # [R, H, 6]
    sector_id = torch.where(in_sector.any(dim=2), torch.argmax(in_sector.to(torch.uint8), dim=2),
                            -1)
    sector_onehot = sector_id[:, None, :] == torch.arange(_NUM_SECTORS, device=dev)[None, :, None]
    cols = torch.arange(h, device=dev)[None, None, :]

    corner = torch.zeros((r, h), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    for _ in range(_MAX_CORNERS_PER_SECTOR):
        eligible = (~picked) & (smooth > edge_threshold) & (sector_id >= 0)
        value = torch.where(eligible, smooth, neg_inf)
        vs = torch.where(sector_onehot, value[:, None, :], neg_inf)  # [R, 6, H]
        best = torch.argmax(vs, dim=2)  # first max, as jnp.argmax
        has = torch.gather(vs, 2, best[..., None])[..., 0] > neg_inf
        sel = ((cols == best[..., None]) & has[..., None]).any(dim=1)
        corner |= sel
        picked = _suppress_neighbors(picked | sel, sel, ring.col)

    surf_mask = (sector_id >= 0) & (~corner) & ring.mask
    corners = _compact_select(ring.xyz, corner, max_corners)
    surfaces = voxel_downsample_rings(ring.xyz, surf_mask, surf_leaf_size, max_surfs)
    return FeatureClouds(corners, surfaces)


def _compact_select(xyz, sel, capacity) -> PaddedCloud:
    flat_xyz = xyz.reshape(-1, 3)
    flat_sel = sel.reshape(-1)
    order = torch.argsort((~flat_sel).to(torch.uint8), stable=True)[:capacity]
    mask = flat_sel[order]
    return PaddedCloud(torch.where(mask[:, None], flat_xyz[order], 0.0), mask)


def voxel_downsample_rings(xyz: torch.Tensor, sel: torch.Tensor, leaf: float,
                           capacity: int) -> PaddedCloud:
    """Per-ring voxel-grid centroid downsample, keyed by (ring, voxel)
    (features.py:174-182). xyz [R, H, 3], sel [R, H]."""
    r, h = sel.shape
    ring_id = torch.arange(r, dtype=torch.int32, device=sel.device)[:, None].expand(r, h)
    return _voxel_downsample_impl(xyz.reshape(-1, 3), sel.reshape(-1), leaf, capacity,
                                  ring_id.reshape(-1))


def _voxel_downsample_impl(xyz, sel, leaf, capacity, ring_id):
    """Sort by the int32 hash, segment boundaries from the exact integer
    coordinates, segment means via index_add_ (features.py:190-223)."""
    coord = torch.floor(xyz / leaf).to(torch.int32)
    key = torch.where(sel, hash_coord(coord, salt=ring_id), 0x7FFFFFFF)
    order = torch.argsort(key, stable=True)
    coord_s, xyz_s, sel_s, ring_s = coord[order], xyz[order], sel[order], ring_id[order]
    same = (coord_s[1:] == coord_s[:-1]).all(dim=1) & sel_s[1:] & sel_s[:-1]
    same &= ring_s[1:] == ring_s[:-1]
    new_seg = torch.cat([torch.ones_like(same[:1]), ~same])
    seg_id = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    seg_id = torch.where(sel_s, torch.clamp(seg_id, max=capacity), capacity)
    sums = xyz.new_zeros(capacity + 1, 3).index_add_(0, seg_id, xyz_s)
    cnts = xyz.new_zeros(capacity + 1).index_add_(0, seg_id, sel_s.to(xyz.dtype))[:capacity]
    centroids = sums[:capacity] / torch.clamp(cnts, min=1.0)[:, None]
    mask = cnts > 0
    return PaddedCloud(torch.where(mask[:, None], centroids, 0.0), mask)

"""Plain reference of the featurization: range-image projection and LOAM
features.

Frozen copy of `rolo_tpu_torch/pointcloud/projection.py`,
`rolo_tpu_torch/pointcloud/features.py`, `rolo_tpu_torch/ops/segment.py`,
`hash_coord` / `_mul32` of `rolo_tpu_torch/voxel/voxelmap.py`,
`concat_clouds` / `compact_cloud` of `rolo_tpu_torch/pointcloud/cloud.py`
and `rpy_to_matrix` of `rolo_tpu_torch/geometry/so3.py`, as of commit
fba7730, in one file that imports nothing of the program. The benchmark
recomputes a scan's feature clouds with it from the raw scan it handed
over and compares them with what the program's timed path produced.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

_M32 = 0xFFFFFFFF


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


def rpy_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll) (pcl::getTransformation convention)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) held in int64, without int64
    overflow: split a into 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_coord(coord: torch.Tensor, salt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., 3] int32 -> int32 hash in [0, 2^30), the reference's uint32
    Murmur3-style finalizer (voxelmap.py:92-111) emulated in int64."""
    c = coord.to(torch.int64) & _M32
    h = (_mul32(c[..., 0], 0x9E3779B1) + _mul32(c[..., 1], 0x85EBCA77)
         + _mul32(c[..., 2], 0xC2B2AE3D)) & _M32
    if salt is not None:
        h = (h + _mul32(salt.to(torch.int64) & _M32, 0x27D4EB2F)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 2).to(torch.int32)


class Segments(NamedTuple):
    """Where each segment's values lie once sorted by id."""

    order: torch.Tensor  # [M] int64 stable sorting permutation, or None when already sorted
    offsets: torch.Tensor  # [S + 1] int64 start of each segment in sorted order


def segments(ids: torch.Tensor, num_segments: int, is_sorted: bool = False) -> Segments:
    """The segments of ids [M] for `num_segments` outputs. Ids outside
    [0, num_segments) belong to no segment. `is_sorted` skips the sort for
    ids that are already non-decreasing."""
    order = None
    if not is_sorted:
        ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return Segments(order, torch.searchsorted(ids, bounds))


def segment_sum(values: torch.Tensor, segs: Segments) -> torch.Tensor:
    """values [M, ...] -> [S, ...]: each segment's values summed in
    sequence order; an empty segment sums to 0."""
    if segs.order is not None:
        values = values[segs.order]
    return torch.segment_reduce(values, "sum", offsets=segs.offsets, axis=0)


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
        rot = rpy_to_matrix(rpy[:, 0], rpy[:, 1], rpy[:, 2])  # [N, 3, 3]
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
    out = _voxel_downsample_impl(xyz.reshape(1, -1, 3), sel.reshape(1, -1), leaf, capacity,
                                 ring_id.reshape(1, -1))
    return PaddedCloud(out.xyz[0], out.mask[0])


def _voxel_downsample_impl(xyz, sel, leaf, capacity, ring_id):
    """Sort each cloud by the int32 hash (salted by the ring when given),
    segment boundaries from the exact integer coordinates, segment means
    from fixed-order segment sums over the sorted ids (features.py:190-223).
    xyz [B, N, 3], sel [B, N]: cloud b's segments are offset by
    b * capacity, so one segment sum serves the batch and sums each cloud's
    points in the order it would alone. Unselected points and the overflow
    belong to no segment (one segment of them would be one long sequential
    sum); with B > 1 that takes a stable sort of the offset ids."""
    bsz = xyz.shape[0]
    coord = torch.floor(xyz / leaf).to(torch.int32)
    key = torch.where(sel, hash_coord(coord, salt=ring_id), 0x7FFFFFFF)
    order = torch.argsort(key, dim=-1, stable=True)
    order3 = order[..., None].expand(*order.shape, 3)
    coord_s, xyz_s = torch.gather(coord, 1, order3), torch.gather(xyz, 1, order3)
    sel_s = torch.gather(sel, 1, order)
    same = (coord_s[:, 1:] == coord_s[:, :-1]).all(dim=-1) & sel_s[:, 1:] & sel_s[:, :-1]
    if ring_id is not None:
        ring_s = torch.gather(ring_id, 1, order)
        same &= ring_s[:, 1:] == ring_s[:, :-1]
    new_seg = torch.cat([torch.ones_like(same[:, :1]), ~same], dim=1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), 1) - 1
    seg_id = torch.where(sel_s, torch.clamp(seg_id, max=capacity), capacity)
    offset = capacity * torch.arange(bsz, device=xyz.device)[:, None]
    seg_id = torch.where(seg_id < capacity, seg_id + offset, bsz * capacity)
    values = torch.cat([xyz_s, sel_s.to(xyz.dtype)[..., None]], dim=-1).reshape(-1, 4)
    sums = segment_sum(values, segments(seg_id.reshape(-1), bsz * capacity, is_sorted=bsz == 1))
    sums = sums.reshape(bsz, capacity, 4)
    cnts = sums[..., 3]
    centroids = sums[..., :3] / torch.clamp(cnts, min=1.0)[..., None]
    mask = cnts > 0
    return PaddedCloud(torch.where(mask[..., None], centroids, 0.0), mask)

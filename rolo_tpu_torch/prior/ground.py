"""Ground map: height queries, local plane fits, patch extraction and the
live ground map, torch port of `rolo_tpu/prior/ground.py` (the reference's
GroundModel). Queries take xy [..., 2] and reduce over the whole masked map,
so the vehicle solver asks for all its wheels in one call where the
reference maps one wheel at a time.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from ..ops.eig3 import eigh3
from ..ops.pytree import tree_from_numpy, tree_to_numpy
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..runtime.platform import default_device

# FitLocalSurface call-site constants (ground.py:22-26)
FIT_RADIUS = 0.6
FIT_OUTLIER_SIGMA = 3.0
FIT_MIN_POINTS = 15


class GroundMap(NamedTuple):
    """Masked ground cloud."""

    xyz: torch.Tensor  # [G, 3]
    mask: torch.Tensor  # [G]

    @property
    def ready(self) -> torch.Tensor:
        return torch.any(self.mask)


def from_cloud(cloud: PaddedCloud) -> GroundMap:
    return GroundMap(cloud.xyz, cloud.mask)


def _xy_d2(gm: GroundMap, xy: torch.Tensor) -> torch.Tensor:
    """[..., G] squared xy distances, inf at masked points."""
    d = gm.xyz[:, :2] - xy[..., None, :]
    return torch.where(gm.mask, torch.sum(d * d, dim=-1), float("inf"))


def nearest_point_xy(gm: GroundMap, xy: torch.Tensor) -> torch.Tensor:
    """The map point whose xy is closest to each query [..., 3]; zeros when
    the map is empty (ground.py:51-57)."""
    pt = gm.xyz[torch.argmin(_xy_d2(gm, xy), dim=-1)]
    return torch.where(gm.ready, pt, 0.0)


def average_height_at(gm: GroundMap, xy: torch.Tensor, radius: float,
                      min_neighbors: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean z of the points within `radius` (xy) of the map point nearest
    to the query, or that point's z with fewer than `min_neighbors`
    (ground.py:60-79). Returns (height [...], ok [])."""
    ni = torch.argmin(_xy_d2(gm, xy), dim=-1)
    center = gm.xyz[ni, :2]
    cd = gm.xyz[:, :2] - center[..., None, :]
    in_r = gm.mask & (torch.sum(cd * cd, dim=-1) <= radius * radius)
    n = in_r.sum(dim=-1)
    mean_z = torch.where(in_r, gm.xyz[:, 2], 0.0).sum(dim=-1) / torch.clamp(n, min=1)
    height = torch.where(n >= min_neighbors, mean_z, gm.xyz[ni, 2])
    return torch.where(gm.ready, height, 0.0), gm.ready


def fit_local_surface(gm: GroundMap, xy: torch.Tensor, radius: float = FIT_RADIUS,
                      outlier_sigma: float = FIT_OUTLIER_SIGMA,
                      min_points: int = FIT_MIN_POINTS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plane fit to the points within `radius` of each query after z-outlier
    rejection at mean +- sigma * std, evaluated at the query xy
    (ground.py:82-119). Returns (point [..., 3], ok [...]); the point is
    zero where the fit fails."""
    in_r = gm.mask & (_xy_d2(gm, xy) <= radius * radius)
    n = in_r.sum(dim=-1)
    z = gm.xyz[:, 2]
    w = in_r.to(z.dtype)
    wsum = torch.clamp(w.sum(dim=-1), min=1.0)
    mean_z = (w * z).sum(dim=-1) / wsum
    std_z = torch.sqrt((w * (z - mean_z[..., None]) ** 2).sum(dim=-1) / wsum)
    inlier = in_r & (torch.abs(z - mean_z[..., None]) <= outlier_sigma * std_z[..., None])
    n_in = inlier.sum(dim=-1)

    wi = inlier.to(z.dtype)
    wisum = torch.clamp(wi.sum(dim=-1), min=1.0)
    centroid = (wi @ gm.xyz) / wisum[..., None]
    centered = gm.xyz - centroid[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", wi, centered, centered)
    _, vecs = eigh3(cov)
    normal = vecs[..., :, 0]  # smallest eigenvalue
    d = -torch.sum(normal * centroid, dim=-1)
    c = normal[..., 2]
    c_ok = torch.abs(c) >= 1e-6
    z_fit = -(normal[..., 0] * xy[..., 0] + normal[..., 1] * xy[..., 1] + d) / torch.where(
        c_ok, c, 1.0)
    ok = gm.ready & (n >= min_points) & (n_in >= min_points) & c_ok
    point = torch.stack([xy[..., 0], xy[..., 1], z_fit], dim=-1)
    return torch.where(ok[..., None], point, 0.0), ok


def contact_point(gm: GroundMap, xy: torch.Tensor) -> torch.Tensor:
    """Plane-fit ground point with the nearest-point fallback (ground.py:122-127)."""
    fitted, ok = fit_local_surface(gm, xy)
    return torch.where(ok[..., None], fitted, nearest_point_xy(gm, xy))


def extract_patch(gm: GroundMap, xy: torch.Tensor, patch_size: float,
                  capacity: int) -> PaddedCloud:
    """Axis-aligned crop of half-width patch_size / 2 around xy, compacted
    in map order into at most `capacity` slots (ground.py:130-141). The
    stable sort keys on an integer cast of the mask."""
    half = 0.5 * patch_size
    inside = (gm.mask & (torch.abs(gm.xyz[:, 0] - xy[0]) <= half)
              & (torch.abs(gm.xyz[:, 1] - xy[1]) <= half))
    order = torch.argsort((~inside).to(torch.uint8), stable=True)[:capacity]
    return PaddedCloud(gm.xyz[order], inside[order])


class LiveGroundMap(NamedTuple):
    """Rolling self-built ground map in the estimate's world frame
    (ground.py:144-164): one slot of segmented, downsampled ground per
    mapping step, in a ring buffer."""

    xyz: torch.Tensor  # [S * C, 3] world frame
    mask: torch.Tensor  # [S * C]
    cursor: torch.Tensor  # [] int32 next slot

    @property
    def ready(self) -> torch.Tensor:
        return torch.any(self.mask)

    def as_ground_map(self) -> GroundMap:
        return GroundMap(self.xyz, self.mask)


def init_live_ground(n_slots: int, slot_capacity: int, device=None,
                     dtype=torch.float32) -> LiveGroundMap:
    device = default_device() if device is None else device
    return LiveGroundMap(
        xyz=torch.zeros(n_slots * slot_capacity, 3, dtype=dtype, device=device),
        mask=torch.zeros(n_slots * slot_capacity, dtype=torch.bool, device=device),
        cursor=torch.tensor(0, dtype=torch.int32, device=device),
    )


def update_live_ground(gm: LiveGroundMap, ground_sensor: PaddedCloud, rot: torch.Tensor,
                       trans: torch.Tensor, slot_capacity: int, leaf: float = 0.4
                       ) -> LiveGroundMap:
    """Insert one scan's segmented ground (sensor frame) at pose (rot,
    trans): downsample to the slot capacity, move to world, overwrite the
    oldest slot (ground.py:175-196). The map is small (~0.4 MB at the
    default 64 x 512 slots), so the update returns new tensors."""
    ds = voxel_downsample(ground_sensor, leaf, slot_capacity)
    world = torch.where(ds.mask[:, None], ds.xyz @ rot.T + trans, 0.0)
    n_slots = gm.xyz.shape[0] // slot_capacity
    start = (gm.cursor.long() % n_slots) * slot_capacity
    pos = start + torch.arange(slot_capacity, device=start.device)
    return LiveGroundMap(xyz=gm.xyz.index_copy(0, pos, world),
                         mask=gm.mask.index_copy(0, pos, ds.mask), cursor=gm.cursor + 1)


def live_ground_to_numpy(gm) -> dict:
    """A LiveGroundMap (this package's or the JAX package's) as numpy
    arrays keyed by field name."""
    return tree_to_numpy(gm)


def live_ground_from_numpy(arrays: Mapping, device) -> LiveGroundMap:
    """A LiveGroundMap on `device` from `live_ground_to_numpy`'s layout."""
    return tree_from_numpy(LiveGroundMap, arrays, device)

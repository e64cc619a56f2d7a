"""Keyframe database as preallocated arrays, torch port of
`rolo_tpu/mapping/keyframes.py`: world-frame keyframe poses and their
sensor-frame feature clouds at fixed capacity with a count, so submap
assembly is a masked gather.

A DB whose fields lead with [B] (count [B]) holds B sequences' keyframes;
every function here takes it with [B] poses, stamps and clouds, and treats
each instance as it would alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry.se3 import SE3
from ..ops.linalg import matmul_each
from ..ops.rows import read_row, write_row_
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..runtime.platform import default_device


class KeyframeDB(NamedTuple):
    rot: torch.Tensor  # [K, 3, 3]
    trans: torch.Tensor  # [K, 3]
    time: torch.Tensor  # [K]
    corner_xyz: torch.Tensor  # [K, C, 3]
    corner_mask: torch.Tensor  # [K, C]
    surf_xyz: torch.Tensor  # [K, S, 3]
    surf_mask: torch.Tensor  # [K, S]
    count: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.rot.shape[-3]

    def valid(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.count.device) < self.count[..., None]


def init_db(max_keyframes: int, corner_cap: int, surf_cap: int, device=None,
            dtype=torch.float32) -> KeyframeDB:
    device = default_device() if device is None else device
    k = max_keyframes
    return KeyframeDB(
        rot=torch.eye(3, dtype=dtype, device=device).repeat(k, 1, 1),
        trans=torch.zeros(k, 3, dtype=dtype, device=device),
        time=torch.zeros(k, dtype=dtype, device=device),
        corner_xyz=torch.zeros(k, corner_cap, 3, dtype=dtype, device=device),
        corner_mask=torch.zeros(k, corner_cap, dtype=torch.bool, device=device),
        surf_xyz=torch.zeros(k, surf_cap, 3, dtype=dtype, device=device),
        surf_mask=torch.zeros(k, surf_cap, dtype=torch.bool, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_keyframe(db: KeyframeDB, pose: SE3, time, corner: PaddedCloud, surf: PaddedCloud,
                 enable=True) -> KeyframeDB:
    """Append a keyframe (keyframes.py:57-83); a no-op when `enable` is
    false or the DB is full. The one row is written in place (the DB is
    ~0.44 GB at `RoloConfig()` capacities); the returned value carries the
    new count."""
    idx = torch.clamp(db.count, max=db.capacity - 1)
    ok = torch.as_tensor(enable, device=db.count.device) & (db.count < db.capacity)
    write_row_(db.rot, idx, pose.rot, ok)
    write_row_(db.trans, idx, pose.trans, ok)
    write_row_(db.time, idx, time, ok)
    write_row_(db.corner_xyz, idx, corner.xyz, ok)
    write_row_(db.corner_mask, idx, corner.mask, ok)
    write_row_(db.surf_xyz, idx, surf.xyz, ok)
    write_row_(db.surf_mask, idx, surf.mask, ok)
    return db._replace(count=db.count + ok.to(torch.int32))


def latest_pose(db: KeyframeDB) -> SE3:
    """The last keyframe's pose (the first slot while the DB is empty)."""
    i = torch.clamp(db.count - 1, min=0)
    return SE3(read_row(db.rot, i), read_row(db.trans, i))


def should_add_keyframe(db: KeyframeDB, pose: SE3, dist_threshold: float,
                        angle_threshold: float) -> torch.Tensor:
    """saveFrame gate (keyframes.py:86-100): the first keyframe, or motion
    from the last one beyond the distance or any rpy angle threshold."""
    xyzrpy = latest_pose(db).inverse().compose(pose).to_xyzrpy()
    moved = (torch.linalg.vector_norm(xyzrpy[..., :3], dim=-1) >= dist_threshold) | torch.any(
        torch.abs(xyzrpy[..., 3:]) >= angle_threshold, dim=-1)
    return (db.count == 0) | moved


def update_poses(db: KeyframeDB, rot: torch.Tensor, trans: torch.Tensor) -> KeyframeDB:
    """Rewrite the valid poses after a graph solve (keyframes.py:103-110)."""
    valid = db.valid()
    return db._replace(rot=torch.where(valid[..., None, None], rot, db.rot),
                       trans=torch.where(valid[..., None], trans, db.trans))


def extract_submap(db: KeyframeDB, query_trans: torch.Tensor, query_time, search_radius: float,
                   recency_sec: float, max_nearby: int, corner_out_cap: int, surf_out_cap: int,
                   corner_leaf: float, surf_leaf: float) -> Tuple[PaddedCloud, PaddedCloud]:
    """The surrounding submap (keyframes.py:113-156): the nearest
    `max_nearby` keyframes among those within `search_radius` of the query
    or within `recency_sec` of its time, their clouds in world coordinates,
    voxel-downsampled. Which ineligible keyframes fill the top-k's spare
    slots may differ from the reference (ties at inf); they are masked.
    With a [B] DB, query_trans [B, 3] and query_time [B] (or a scalar), the
    clouds lead with [B]."""
    if db.rot.dim() == 3:
        one = KeyframeDB(*(t[None] for t in db))
        subs = extract_submap(one, query_trans[None], query_time, search_radius, recency_sec,
                              max_nearby, corner_out_cap, surf_out_cap, corner_leaf, surf_leaf)
        return tuple(PaddedCloud(c.xyz[0], c.mask[0]) for c in subs)
    bsz = db.rot.shape[0]
    query_time = torch.as_tensor(query_time, dtype=db.time.dtype, device=db.time.device)
    d2 = torch.sum((db.trans - query_trans[:, None, :]) ** 2, dim=-1)
    recent = (query_time.reshape(-1, 1) - db.time) < recency_sec
    eligible = db.valid() & ((d2 <= search_radius ** 2) | recent)
    score = torch.where(eligible, d2, float("inf"))
    sel = torch.topk(score, min(max_nearby, db.capacity), dim=-1, largest=False).indices
    sel_ok = torch.isfinite(torch.gather(score, 1, sel))
    nsel = sel.shape[1]
    rot = torch.gather(db.rot, 1, sel[..., None, None].expand(bsz, nsel, 3, 3))
    trans = torch.gather(db.trans, 1, sel[..., None].expand(bsz, nsel, 3))

    def gather(xyz_all, mask_all, out_cap, leaf):
        n = xyz_all.shape[2]
        xyz = torch.gather(xyz_all, 1, sel[..., None, None].expand(bsz, nsel, n, 3))
        world = matmul_each(xyz, rot.transpose(-1, -2)) + trans[:, :, None, :]
        mask = torch.gather(mask_all, 1, sel[..., None].expand(bsz, nsel, n)) & sel_ok[..., None]
        return voxel_downsample(PaddedCloud(world.reshape(bsz, -1, 3), mask.reshape(bsz, -1)),
                                leaf, out_cap)

    return (gather(db.corner_xyz, db.corner_mask, corner_out_cap, corner_leaf),
            gather(db.surf_xyz, db.surf_mask, surf_out_cap, surf_leaf))

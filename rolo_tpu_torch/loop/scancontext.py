"""Scan Context descriptors and their store, torch port of the descriptor
half of `rolo_tpu/loop/scancontext.py`: the 20-ring x 60-sector max-z polar
image of a scan, its ring and sector keys, and the fixed-capacity store the
back-end appends one descriptor to per keyframe. Loop detection over the
store (`detect_loop`) belongs to the loop-closure slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.rows import write_row_


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, num_ring: int = 20,
                    num_sector: int = 60, max_radius: float = 80.0,
                    lidar_height: float = 2.0) -> torch.Tensor:
    """Polar max-z descriptor [num_ring, num_sector] (scancontext.py:36-74):
    ring = clamp(ceil(r / R_max * NR), 1, NR), sector = clamp(ceil(theta_deg
    / 360 * NS), 1, NS), z lifted by `lidar_height`, empty bins 0. The bin
    max is a scatter-reduce here where the reference sorts (the same exact
    maximum)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2] + lidar_height
    azim_range = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    ring = torch.clamp(torch.ceil(azim_range / max_radius * num_ring), 1, num_ring) - 1
    sector = torch.clamp(torch.ceil(theta / 360.0 * num_sector), 1, num_sector) - 1
    valid = mask & (azim_range <= max_radius)
    n_bins = num_ring * num_sector
    flat = torch.where(valid, ring.long() * num_sector + sector.long(), n_bins)
    desc = z.new_zeros(n_bins + 1).scatter_reduce_(0, flat, z, "amax", include_self=False)
    return desc[:n_bins].reshape(num_ring, num_sector)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rowwise mean [..., R]."""
    return desc.mean(dim=-1)


def sector_key(desc: torch.Tensor) -> torch.Tensor:
    """Colwise mean [..., S]."""
    return desc.mean(dim=-2)


class ScanContextDB(NamedTuple):
    """Fixed-capacity descriptor store (scancontext.py:87-98)."""

    desc: torch.Tensor  # [K, R, S]
    rkey: torch.Tensor  # [K, R]
    skey: torch.Tensor  # [K, S]
    count: torch.Tensor  # [] int32

    @property
    def capacity(self) -> int:
        return self.desc.shape[0]


def init_db(capacity: int, num_ring: int = 20, num_sector: int = 60, device=None,
            dtype=torch.float32) -> ScanContextDB:
    return ScanContextDB(
        desc=torch.zeros(capacity, num_ring, num_sector, dtype=dtype, device=device),
        rkey=torch.zeros(capacity, num_ring, dtype=dtype, device=device),
        skey=torch.zeros(capacity, num_sector, dtype=dtype, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_descriptor(db: ScanContextDB, desc: torch.Tensor, enable=True) -> ScanContextDB:
    """Append one descriptor with its keys (scancontext.py:110-124); a no-op
    when `enable` is false or the store is full. Rows are written in place;
    the returned value carries the new count."""
    idx = torch.clamp(db.count, max=db.capacity - 1)
    ok = torch.as_tensor(enable, device=db.count.device) & (db.count < db.capacity)
    write_row_(db.desc, idx, desc, ok)
    write_row_(db.rkey, idx, ring_key(desc), ok)
    write_row_(db.skey, idx, sector_key(desc), ok)
    return db._replace(count=db.count + ok.to(torch.int32))

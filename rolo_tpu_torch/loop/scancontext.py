"""Scan Context place recognition, torch port of `rolo_tpu/loop/scancontext.py`:
the 20-ring x 60-sector max-z polar image of a scan, its ring and sector keys,
the fixed-capacity store the back-end appends one descriptor to per keyframe,
and `detect_loop` over that store (ring-key top-k candidates, sector-key
circular-shift alignment, refined cosine distance over the shift window).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import LoopConfig
from ..ops.rows import read_row, write_row_
from ..runtime.platform import default_device


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor, num_ring: int = 20,
                    num_sector: int = 60, max_radius: float = 80.0,
                    lidar_height: float = 2.0) -> torch.Tensor:
    """Polar max-z descriptor [num_ring, num_sector] (scancontext.py:36-74):
    ring = clamp(ceil(r / R_max * NR), 1, NR), sector = clamp(ceil(theta_deg
    / 360 * NS), 1, NS), z lifted by `lidar_height`, empty bins 0. The bin
    max is a scatter-reduce here where the reference sorts (the same exact
    maximum). xyz [..., N, 3], mask [..., N] -> [..., num_ring, num_sector]:
    each cloud of a batch bins into its own slice of one scatter."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2] + lidar_height
    azim_range = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x) * (180.0 / math.pi)
    theta = torch.where(theta < 0, theta + 360.0, theta)
    ring = torch.clamp(torch.ceil(azim_range / max_radius * num_ring), 1, num_ring) - 1
    sector = torch.clamp(torch.ceil(theta / 360.0 * num_sector), 1, num_sector) - 1
    valid = mask & (azim_range <= max_radius)
    n_bins = num_ring * num_sector
    lead = mask.shape[:-1]
    n_clouds = mask[..., 0].numel()
    flat = torch.where(valid, ring.long() * num_sector + sector.long(), n_bins)
    flat = flat.reshape(n_clouds, -1) + (n_bins + 1) * torch.arange(n_clouds,
                                                                     device=flat.device)[:, None]
    desc = z.new_zeros(n_clouds * (n_bins + 1)).scatter_reduce_(
        0, flat.reshape(-1), z.reshape(-1), "amax", include_self=False)
    return desc.reshape(n_clouds, n_bins + 1)[:, :n_bins].reshape(*lead, num_ring, num_sector)


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
        return self.desc.shape[-3]


def init_db(capacity: int, num_ring: int = 20, num_sector: int = 60, device=None,
            dtype=torch.float32) -> ScanContextDB:
    device = default_device() if device is None else device
    return ScanContextDB(
        desc=torch.zeros(capacity, num_ring, num_sector, dtype=dtype, device=device),
        rkey=torch.zeros(capacity, num_ring, dtype=dtype, device=device),
        skey=torch.zeros(capacity, num_sector, dtype=dtype, device=device),
        count=torch.tensor(0, dtype=torch.int32, device=device),
    )


def add_descriptor(db: ScanContextDB, desc: torch.Tensor, enable=True) -> ScanContextDB:
    """Append one descriptor with its keys (scancontext.py:110-124); a no-op
    when `enable` is false or the store is full. Rows are written in place;
    the returned value carries the new count. A store whose fields lead with
    [B] takes [B] descriptors and guards."""
    idx = torch.clamp(db.count, max=db.capacity - 1)
    ok = torch.as_tensor(enable, device=db.count.device) & (db.count < db.capacity)
    write_row_(db.desc, idx, desc, ok)
    write_row_(db.rkey, idx, ring_key(desc), ok)
    write_row_(db.skey, idx, sector_key(desc), ok)
    return db._replace(count=db.count + ok.to(torch.int32))


class LoopDetection(NamedTuple):
    index: torch.Tensor  # [] int32 matched keyframe (valid iff found)
    yaw_rad: torch.Tensor  # [] yaw offset of the match
    distance: torch.Tensor  # [] best scan-context distance
    found: torch.Tensor  # [] bool


def _sc_distance(query: torch.Tensor, cand_shifted: torch.Tensor) -> torch.Tensor:
    """Mean column cosine distance (scancontext.py:134-146): query [R, S],
    cand_shifted [..., R, S] -> [...]; columns where either side has zero
    norm are left out of the mean."""
    qn = torch.linalg.vector_norm(query, dim=-2)
    cn = torch.linalg.vector_norm(cand_shifted, dim=-2)
    dot = torch.einsum("rs,...rs->...s", query, cand_shifted)
    eff = (qn > 0) & (cn > 0)
    sim = torch.where(eff, dot / torch.clamp(qn * cn, min=1e-12), 0.0)
    n_eff = torch.clamp(eff.sum(dim=-1), min=1)
    return 1.0 - sim.sum(dim=-1) / n_eff


def detect_loop(db: ScanContextDB, cfg: LoopConfig = LoopConfig()) -> LoopDetection:
    """Loop candidate for the newest descriptor (scancontext.py:149-206):
    the `sc_num_candidates` nearest ring keys among all but the newest
    `sc_num_exclude_recent`, each aligned by the sector-key circular shift,
    then refined over +-round(sc_search_ratio / 2 * S) shifts. `torch.topk`
    may order tied candidates differently from `lax.top_k`; the winner is
    the first minimum of the refined distances in both."""
    num_s = db.desc.shape[-1]
    dev = db.desc.device
    cur = torch.clamp(db.count - 1, min=0)
    query, q_rkey, q_skey = read_row(db.desc, cur), read_row(db.rkey, cur), read_row(db.skey, cur)

    eligible = torch.arange(db.capacity, device=dev) < (db.count - cfg.sc_num_exclude_recent)
    d_rk = torch.where(eligible, torch.sum((db.rkey - q_rkey) ** 2, dim=-1), float("inf"))
    cand = torch.topk(d_rk, cfg.sc_num_candidates, largest=False).indices  # [C]
    cand_ok = torch.isfinite(d_rk[cand])

    # circshift(x, s)[c] = x[(c - s) mod S], every shift at once
    cols = torch.arange(num_s, device=dev)
    shift_idx = (cols[None, :] - cols[:, None]) % num_s  # [S_shift, S_col]
    skey_shifted = db.skey[cand][:, shift_idx]  # [C, S_shift, S]
    vkey_diff = torch.linalg.vector_norm(skey_shifted - q_skey, dim=-1)
    best_shift = torch.argmin(vkey_diff, dim=-1)  # [C]

    radius = round(0.5 * cfg.sc_search_ratio * num_s)
    offsets = torch.arange(-radius, radius + 1, device=dev)
    shifts = (best_shift[:, None] + offsets[None, :]) % num_s  # [C, NS]
    cand_desc = db.desc[cand]  # [C, R, S]
    c, ns = shifts.shape
    gather = (cols[None, None, :] - shifts[:, :, None]) % num_s  # [C, NS, S]
    desc_shifted = torch.gather(cand_desc[:, None].expand(c, ns, *cand_desc.shape[1:]), -1,
                                gather[:, :, None, :].expand(c, ns, cand_desc.shape[1], num_s))
    dist = torch.where(cand_ok[:, None], _sc_distance(query, desc_shifted), float("inf"))

    flat = torch.argmin(dist.reshape(-1))
    min_dist = dist.reshape(-1)[flat]
    nn_idx = cand[flat // ns]
    nn_shift = shifts.reshape(-1)[flat]
    enough_history = db.count >= cfg.sc_num_exclude_recent + 1
    return LoopDetection(
        index=nn_idx.to(torch.int32),
        yaw_rad=nn_shift.to(query.dtype) * (2.0 * math.pi / num_s),
        distance=torch.where(enough_history, min_dist, float("inf")),
        found=enough_history & (min_dist < cfg.sc_dist_threshold),
    )

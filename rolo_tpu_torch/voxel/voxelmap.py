"""Voxel maps over fixed-slot tensors, torch port of
`rolo_tpu/voxel/voxelmap.py`.

A voxel map is a sorted table of packed bins with SoA stat planes
[B, 10, V] (num, mean xyz, cov6). The build sorts the packs, marks run
starts, and sums each run with kernel K1 (`keyed_matmul`); a lookup joins
query packs against the sorted table with the same kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops import sym3
from ..ops.voxel_join import INVALID_PACK, keyed_matmul, pack_polar, pack_uniform

_M32 = 0xFFFFFFFF


def polar_bins(x, y, z, polar_res: Sequence[float]):
    """(x, y, z) -> (theta, phi, r) int32 bins (voxelmap.py:54-63)."""
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.atan2(y, x) + math.pi
    phi = torch.arccos(torch.clamp(z / torch.clamp(r, min=1e-12), -1.0, 1.0))
    tb = torch.floor(theta / polar_res[0]).to(torch.int32)
    pb = torch.floor(phi / polar_res[1]).to(torch.int32)
    rb = torch.floor(r / polar_res[2]).to(torch.int32)
    return tb, pb, rb


def polar_coord(xyz: torch.Tensor, polar_res: Sequence[float]) -> torch.Tensor:
    return torch.stack(polar_bins(xyz[..., 0], xyz[..., 1], xyz[..., 2], polar_res), dim=-1)


def uniform_bins(x, y, z, resolution: float):
    """Cartesian bins floor(a / res - 0.5) (voxelmap.py:84-89)."""
    def f(a):
        return torch.floor(a / resolution - 0.5).to(torch.int32)

    return f(x), f(y), f(z)


def uniform_coord(xyz: torch.Tensor, resolution: float) -> torch.Tensor:
    return torch.stack(uniform_bins(xyz[..., 0], xyz[..., 1], xyz[..., 2], resolution), dim=-1)


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


class VoxelMap(NamedTuple):
    """Sorted fixed-capacity voxel tables, batched SoA.

    pack [B, V] int32 ascending (INVALID_PACK for empty slots; duplicate
    slots repeat their run start's pack with valid=False and zero stats);
    stats [B, 10, V]; num_points [B, V]; mean [B, 3, V]; cov6 [B, 6, V];
    kappa [B, V]; valid [B, V] bool."""

    pack: torch.Tensor
    stats: torch.Tensor
    num_points: torch.Tensor
    mean: torch.Tensor
    cov6: torch.Tensor
    kappa: torch.Tensor
    valid: torch.Tensor


def _kappa_from_rbar(r_bar: torch.Tensor) -> torch.Tensor:
    """vMF concentration approximation (voxelmap.py:142-147)."""
    series = 3.0 * r_bar * (1.0 + 0.6 * r_bar**2 + (99.0 / 175.0) * r_bar**4)
    exact = r_bar * (3.0 - r_bar**2) / torch.clamp(1.0 - r_bar**2, min=1e-9)
    k = torch.where(r_bar < 0.6, series, exact)
    return torch.where(r_bar < 1e-8, 0.0, k)


def build_voxel_map(xyz: torch.Tensor, cov6: torch.Tensor, mask: torch.Tensor, capacity: int,
                    polar_res: Optional[Sequence[float]] = None,
                    resolution: float = 1.0) -> VoxelMap:
    """Voxel maps from padded clouds: xyz [B, N, 3], cov6 [B, 6, N],
    mask [B, N]. polar_res given -> POLAR bins, else UNIFORM.

    capacity >= N keeps the sorted packs with duplicates as the table and
    marks run starts valid (the reference's fast path, voxelmap.py:181-199);
    a smaller capacity compacts the smallest `capacity` unique packs."""
    n = xyz.shape[1]
    capacity = min(capacity, ((n + 127) // 128) * 128)
    if polar_res is not None:
        pack = pack_polar(polar_coord(xyz, polar_res))
    else:
        pack = pack_uniform(uniform_coord(xyz, resolution))
    pack = torch.where(mask, pack, INVALID_PACK).to(torch.int32)

    sp = torch.sort(pack, dim=-1).values
    is_valid = sp != INVALID_PACK
    first = torch.ones_like(sp[:, :1], dtype=torch.bool)
    new_seg = is_valid & torch.cat([first, sp[:, 1:] != sp[:, :-1]], dim=1)
    if capacity >= n:
        table_pack = sp
        valid = new_seg
    else:
        n_seg = new_seg.sum(dim=1, keepdim=True)
        seg_id = torch.where(is_valid, torch.cumsum(new_seg.to(torch.int32), 1) - 1, 2**30)
        slot = torch.arange(capacity, dtype=seg_id.dtype, device=xyz.device)
        slot = slot.expand(xyz.shape[0], capacity).contiguous()
        pos = torch.clamp(torch.searchsorted(seg_id.contiguous(), slot), 0, n - 1)
        valid = slot < n_seg
        table_pack = torch.where(valid, torch.gather(sp, 1, pos), INVALID_PACK).to(torch.int32)

    w = mask.to(xyz.dtype)
    data = torch.cat([w[:, None, :], xyz.transpose(1, 2) * w[:, None, :], cov6 * w[:, None, :]], 1)
    sums = keyed_matmul(data.contiguous(), pack.contiguous(), table_pack.contiguous())

    num = sums[:, 0]
    denom = torch.clamp(num, min=1.0)
    mean = sums[:, 1:4] / denom[:, None]
    cov = sums[:, 4:10] / denom[:, None]
    r_bar = torch.sqrt(torch.sum(sums[:, 1:4] ** 2, dim=1)) / denom
    kappa = torch.where(valid, _kappa_from_rbar(r_bar), 0.0)
    vmask = valid[:, None, :]
    stats = torch.where(vmask, torch.cat([num[:, None], mean, cov], dim=1), 0.0)
    return VoxelMap(
        pack=table_pack.contiguous(),
        stats=stats.contiguous(),
        num_points=torch.where(valid, num, 0.0),
        mean=torch.where(vmask, mean, 0.0),
        cov6=torch.where(vmask, cov, 0.0),
        kappa=kappa,
        valid=valid,
    )


def lookup(vmap: VoxelMap, coord: torch.Tensor, polar: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Binary-search lookup (the join's oracle): coord [B, M, 3] ->
    (found [B, M], num [B, M], mean [B, M, 3], cov [B, M, 3, 3])."""
    q = pack_polar(coord) if polar else pack_uniform(coord)
    cap = vmap.pack.shape[1]
    idx = torch.clamp(torch.searchsorted(vmap.pack, q.contiguous()), 0, cap - 1)
    found = (torch.gather(vmap.pack, 1, idx) == q) & torch.gather(vmap.valid, 1, idx)
    found &= q != INVALID_PACK
    num = torch.where(found, torch.gather(vmap.num_points, 1, idx), 0.0)
    mean = torch.gather(vmap.mean, 2, idx[:, None, :].expand(-1, 3, -1)).transpose(1, 2)
    cov6 = torch.gather(vmap.cov6, 2, idx[:, None, :].expand(-1, 6, -1))
    mean = torch.where(found[..., None], mean, 0.0)
    cov = torch.where(found[..., None, None], sym3.to_mat(cov6), 0.0)
    return found, num, mean, cov


def lookup_join(vmap: VoxelMap, pack: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keyed-sum lookup, the production binding path: pack [B, M] ->
    (found [B, M], num [B, M], mean [B, 3, M], cov6 [B, 6, M])."""
    out = keyed_matmul(vmap.stats, vmap.pack, pack.contiguous(), keys_sorted=True)
    num = out[:, 0]
    return num > 0.0, num, out[:, 1:4], out[:, 4:10]

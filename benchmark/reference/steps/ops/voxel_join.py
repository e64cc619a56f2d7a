"""Kernel K1's entry as the copied modules call it, computed by the plain
reference (`benchmark/reference/kernels.py`), and the packed-coordinate
helpers: lines 28-63 of `rolo_tpu_torch/ops/voxel_join.py` as of commit
fba7730."""

from __future__ import annotations

import torch

from ... import kernels as _plain

# Packed-coordinate layout (exact, collision-free for in-range bins):
#   polar:   theta[7b] << 24 | phi[6b] << 18 | r[18b]
#   uniform: (x+512)[10b] << 20 | (y+512)[10b] << 10 | (z+512)[10b]
INVALID_PACK = 0x7FFFFFFF
MAX_PLANES = 16
MAX_SHARED_KEYS = 232448 // 4  # int32 table keys in the 227 KB a block may hold
_CHUNK = 1024  # query columns per one-hot tile in the plain version


def pack_polar(coord: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 (theta, phi, r) bins -> packed int32; out-of-range
    bins map to INVALID_PACK."""
    t, p, r = coord[..., 0], coord[..., 1], coord[..., 2]
    ok = (t >= 0) & (t < 128) & (p >= 0) & (p < 64) & (r >= 0) & (r < (1 << 18))
    packed = (t << 24) | (p << 18) | r
    return torch.where(ok, packed, INVALID_PACK).to(torch.int32)


def unpack_polar(pack: torch.Tensor) -> torch.Tensor:
    return torch.stack([(pack >> 24) & 0x7F, (pack >> 18) & 0x3F, pack & 0x3FFFF], dim=-1)


def pack_uniform(coord: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 cartesian bins -> packed int32 (valid |bin| < 512)."""
    c = coord + 512
    ok = torch.all((c >= 0) & (c < 1024), dim=-1)
    packed = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    return torch.where(ok, packed, INVALID_PACK).to(torch.int32)


def unpack_uniform(pack: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [((pack >> 20) & 0x3FF) - 512, ((pack >> 10) & 0x3FF) - 512, (pack & 0x3FF) - 512], dim=-1
    )




def keyed_matmul(values, keys_k, keys_m, keys_sorted: bool = False, run_heads: bool = False):
    return _plain.keyed_matmul(values, keys_k, keys_m)

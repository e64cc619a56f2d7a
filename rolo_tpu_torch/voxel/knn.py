"""Per-point covariances from k-NN neighbourhoods, torch port of
`rolo_tpu/voxel/knn.py` (the "moment" and "exact" selectors with PLANE or
no regularization).

"moment" is the production path: the neighbourhood moments come from
kernel K2 (`ops/knn_moments.py`) for any candidate count, and the
covariance is the reference's E[xx] - mu mu^T formula (with its f32
cancellation, knn.py:176-180, reproduced rather than fixed). "exact" is
top-k indices plus a gather, the oracle.
"""

from __future__ import annotations

import torch

from ..ops import sym3
from ..ops.knn_moments import knn_moments

PLANE = "plane"
NONE = "none"
_CHUNK = 512  # queries per distance tile of the exact selector


def _d2_chunk(qc: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, C, N] squared distances, elementwise difference form."""
    dx = qc[:, :, None, 0] - points[:, None, :, 0]
    dy = qc[:, :, None, 1] - points[:, None, :, 1]
    dz = qc[:, :, None, 2] - points[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def knn_indices(query: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                k: int) -> torch.Tensor:
    """k nearest valid points of each query, elementwise distance form.

    query [B, Q, 3], points [B, N, 3], points_mask [B, N] -> idx [B, Q, k]
    int64, nearest first. Invalid points lie at infinite distance."""
    points = torch.where(points_mask[..., None], points, 0.0)
    inf_row = torch.where(points_mask, 0.0, float("inf"))[:, None, :]
    out = []
    for q0 in range(0, query.shape[1], _CHUNK):
        d2 = _d2_chunk(query[:, q0:q0 + _CHUNK], points) + inf_row
        out.append(torch.topk(d2, k, dim=-1, largest=False, sorted=True).indices)
    return torch.cat(out, dim=1)


def moment_table(cand_xyz: torch.Tensor, cand_mask: torch.Tensor) -> torch.Tensor:
    """[B, 10, N] planes (1, x, y, z, xx, xy, xz, yy, yz, zz), zero at
    invalid candidates."""
    x, y, z = cand_xyz[..., 0], cand_xyz[..., 1], cand_xyz[..., 2]
    xc = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], 1)
    return xc * cand_mask[:, None, :].to(xc.dtype)


def cov6_from_moments(mom: torch.Tensor, k: int) -> torch.Tensor:
    """[B, >=10, N] neighbourhood sums -> [B, 6, N] covariance planes:
    (E[xx] - mu mu^T) rescaled to the reference's sum/k (knn.py:294-304)."""
    cnt = torch.clamp(mom[:, 0], min=1.0)
    mu = mom[:, 1:4] / cnt[:, None]
    exx = mom[:, 4:10] / cnt[:, None]
    cov6 = torch.stack(
        [
            exx[:, 0] - mu[:, 0] * mu[:, 0],
            exx[:, 1] - mu[:, 0] * mu[:, 1],
            exx[:, 2] - mu[:, 0] * mu[:, 2],
            exx[:, 3] - mu[:, 1] * mu[:, 1],
            exx[:, 4] - mu[:, 1] * mu[:, 2],
            exx[:, 5] - mu[:, 2] * mu[:, 2],
        ],
        dim=1,
    )
    return cov6 * (cnt / float(k))[:, None, :]


def estimate_cov6(xyz: torch.Tensor, mask: torch.Tensor, k: int = 20, method: str = PLANE,
                  selector: str = "moment") -> torch.Tensor:
    """Per-point regularized covariances, SoA: xyz [B, N, 3], mask [B, N]
    -> [B, 6, N] sym3 planes (identity at masked points)."""
    if method not in (PLANE, NONE):
        raise ValueError(f"regularization {method!r} is not ported yet (needs ops/eig3)")
    xyz = torch.where(mask[..., None], xyz, 0.0)
    if selector == "exact":
        idx = knn_indices(xyz, xyz, mask, k)  # [B, N, k]
        b, n, _ = idx.shape
        neigh = torch.gather(xyz, 1, idx.reshape(b, n * k, 1).expand(b, n * k, 3))
        neigh = neigh.reshape(b, n, k, 3)
        centered = neigh - neigh.mean(dim=2, keepdim=True)
        cx, cy, cz = centered[..., 0], centered[..., 1], centered[..., 2]

        def comp(a, c):
            return torch.sum(a * c, dim=2) / float(k)

        cov6 = torch.stack(
            [comp(cx, cx), comp(cx, cy), comp(cx, cz), comp(cy, cy), comp(cy, cz), comp(cz, cz)],
            dim=1,
        )
    elif selector == "moment":
        mom = knn_moments(xyz.contiguous(), mask.contiguous(), xyz.contiguous(),
                          mask.contiguous(), moment_table(xyz, mask).contiguous(), k)
        cov6 = cov6_from_moments(mom, k)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    if method == PLANE:
        cov6 = sym3.plane_regularize(cov6)
    return torch.where(mask[:, None, :], cov6, sym3.identity_like(cov6))

"""k-NN search and per-point covariances from k-NN neighbourhoods, torch
port of `rolo_tpu/voxel/knn.py`.

`knn_indices` takes the reference's arguments: the distance in the matmul
form |q|^2 - 2 q.x + |x|^2 (full f32; the scan-to-submap binds, the loop and
prior ICPs) or the cancellation-free elementwise form (covariance
neighbourhoods), and `approximate=True` as an exact top-k, which is what the
reference computes off the TPU. On CUDA tensors the matmul form is kernel
K3 (`ops/knn_select.py`) for every k up to its MAX_K, 64 (a larger k
raises there), with no distance tile in device memory. CPU tensors and the
elementwise form (`estimate_cov6`'s exact oracle) are the plain version:
[chunk, N] tiles (q.x one matmul per cloud of a batch, `matmul_each`, so
each rounds as alone, where cuBLAS's batched matmul picks its kernel by the
batch), `torch.topk`, and a plain argmin for k=1. Traced runs count the calls each serves
(`knn.kernel_calls` / `knn.plain_calls`).

In `estimate_cov6`, "moment" is the production path: the neighbourhood
moments come from kernel K2 (`ops/knn_moments.py`) for any candidate count,
and the covariance is the reference's E[xx] - mu mu^T formula (with its f32
cancellation, knn.py:176-180, reproduced rather than fixed). "exact" is
top-k indices plus a gather, the oracle. All five regularizations of the
reference are available; the non-PLANE ones run on the closed-form
`ops/eig3.py`.
"""

from __future__ import annotations

import torch

from ..ops import sym3
from ..ops.eig3 import eigh3
from ..ops.knn_moments import knn_moments
from ..ops.knn_select import knn_select, pack_points
from ..ops.linalg import matmul_each
from ..runtime import profiling

PLANE = "plane"
MIN_EIG = "min_eig"
NORMALIZED_MIN_EIG = "normalized_min_eig"
FROBENIUS = "frobenius"
NONE = "none"
_CHUNK = 512  # queries per distance tile of the exact selector


def _d2_chunk(qc: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, C, N] squared distances, elementwise difference form."""
    dx = qc[:, :, None, 0] - points[:, None, :, 0]
    dy = qc[:, :, None, 1] - points[:, None, :, 1]
    dz = qc[:, :, None, 2] - points[:, None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _flat(query, points, points_mask):
    """Queries [B, Q, 3], points [B, N, 3] with invalid coordinates zeroed,
    their mask [B, N] and |x|^2 [B, N], the batch's leading dims flattened."""
    q = query.reshape(-1, *query.shape[-2:])
    pm = points_mask.reshape(-1, points_mask.shape[-1])
    pts = torch.where(pm[..., None], points.reshape(-1, *points.shape[-2:]), 0.0)
    return q, pts, pm, torch.sum(pts * pts, dim=-1)


def kernel_operands(query, points, points_mask):
    """K3's operands from `knn_indices`' arguments: q [B, Q, 3], |q|^2 [B, Q]
    and the (x, y, z, xx) rows [B, N, 4], |q|^2 and the masked |x|^2 (+inf
    at invalid points) computed by the plain tile's ops, so that K3's d is
    the tile's."""
    q, pts, pm, x2 = _flat(query, points, points_mask)
    return q, torch.sum(q * q, dim=-1), pack_points(pts, torch.where(pm, x2, float("inf")))


def _tile(qc, pts, pm, x2, form):
    """[B, C, N] distances of a chunk of queries, +inf at invalid points."""
    if form == "elementwise":
        d2 = _d2_chunk(qc, pts)
    else:
        d2 = (torch.sum(qc * qc, dim=-1, keepdim=True)
              - 2.0 * matmul_each(qc, pts.transpose(1, 2)) + x2[:, None, :])
    return d2 + torch.where(pm, 0.0, float("inf"))[:, None, :]


def distance_tile(query: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                  form: str = "matmul") -> torch.Tensor:
    """The plain version's distances of one chunk of queries, [..., C, N]:
    the values `knn_indices` ranks (for tests that compare with them)."""
    q, pts, pm, x2 = _flat(query, points, points_mask)
    return _tile(q, pts, pm, x2, form).reshape(*query.shape[:-1], pts.shape[1])


def knn_indices_plain(query: torch.Tensor, points: torch.Tensor, points_mask: torch.Tensor,
                      k: int, chunk: int = 512, form: str = "matmul") -> torch.Tensor:
    """The plain version of `knn_indices`, on any device: a [B, chunk, N]
    distance tile per chunk of queries, then `torch.topk` (`torch.argmin`
    for k=1). The CPU path, and kernel K3's oracle on the card."""
    q, pts, pm, x2 = _flat(query, points, points_mask)
    out = []
    for q0 in range(0, q.shape[1], chunk):
        d2 = _tile(q[:, q0:q0 + chunk], pts, pm, x2, form)
        if k == 1:
            out.append(torch.argmin(d2, dim=-1, keepdim=True))
        else:
            out.append(torch.topk(d2, k, dim=-1, largest=False, sorted=True).indices)
    return torch.cat(out, dim=1).reshape(*query.shape[:-1], k)


def knn_indices(query: torch.Tensor, query_mask: torch.Tensor, points: torch.Tensor,
                points_mask: torch.Tensor, k: int, chunk: int = 512, approximate: bool = False,
                recall_target: float = 0.95, form: str = "matmul") -> torch.Tensor:
    """k nearest valid points of each query (knn.py:45-121), nearest first.

    query [..., Q, 3], query_mask [..., Q], points [..., N, 3], points_mask
    [..., N] -> idx [..., Q, k] int64; the leading dims are an optional batch
    shared by all four. Invalid points lie at infinite distance (their
    coordinates, NaN included, never enter a distance); where fewer than k
    points are valid the tail points at invalid ones. Rows of invalid queries
    are arbitrary, as in the reference, and are masked downstream.
    `approximate` and `recall_target` select the TPU's approximate top-k in
    the reference; off the TPU it computes the exact top-k, and so does this
    port. Ties among equal distances go to the lower index on the card's
    kernel path and for k=1 (`torch.argmin`), and may pick other indices
    than the reference's top-k elsewhere. `chunk` is the plain version's
    queries per tile; the kernel path tiles by itself."""
    del query_mask, approximate, recall_target  # see the docstring
    if form not in ("matmul", "elementwise"):
        raise ValueError(f"unknown distance form {form!r}")
    if form == "matmul" and query.is_cuda:  # K3's wrapper refuses k above its MAX_K
        idx = knn_select(*kernel_operands(query, points, points_mask), k)
        profiling.count("knn.kernel_calls", 1)
        return idx.reshape(*query.shape[:-1], k)
    profiling.count("knn.plain_calls", 1)
    return knn_indices_plain(query, points, points_mask, k, chunk, form)


def regularize_covariance(cov: torch.Tensor, method: str = PLANE) -> torch.Tensor:
    """Eigenvalue surgery on [..., 3, 3] covariances (knn.py:124-147)."""
    if method == NONE:
        return cov
    if method == FROBENIUS:
        c = cov + 1e-3 * torch.eye(3, dtype=cov.dtype, device=cov.device)
        c_inv = torch.linalg.inv(c)
        norm = torch.linalg.vector_norm(c_inv.reshape(*c_inv.shape[:-2], 9), dim=-1)
        return torch.linalg.inv(c_inv / norm[..., None, None])
    eigval, eigvec = eigh3(cov)  # ascending
    if method == PLANE:
        values = torch.tensor([1e-3, 1.0, 1.0], dtype=cov.dtype,
                              device=cov.device).expand_as(eigval)
    elif method == MIN_EIG:
        values = torch.clamp(eigval, min=1e-3)
    elif method == NORMALIZED_MIN_EIG:
        values = torch.clamp(eigval / torch.clamp(eigval[..., -1:], min=1e-12), min=1e-3)
    else:
        raise ValueError(f"unknown regularization {method}")
    return torch.einsum("...ij,...j,...kj->...ik", eigvec, values, eigvec)


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
                  selector: str = "moment", cand_xyz: torch.Tensor = None,
                  cand_mask: torch.Tensor = None) -> torch.Tensor:
    """Per-point regularized covariances, SoA: xyz [B, N, 3], mask [B, N]
    -> [B, 6, N] sym3 planes (identity at masked points).

    cand_xyz [B, M, 3] / cand_mask [B, M]: the neighbour candidates when they
    are not the queries themselves (knn.py:192-204): the point-sharded path
    queries its shard against the gathered cloud (parallel/spmd.py). The
    queries must be among the candidates for each point to be its own
    nearest neighbour, as the reference requires."""
    xyz = torch.where(mask[..., None], xyz, 0.0)
    if cand_xyz is None:
        cand_xyz, cand_mask = xyz, mask
    else:
        cand_xyz = torch.where(cand_mask[..., None], cand_xyz, 0.0)
    if selector == "exact":
        idx = knn_indices(xyz, mask, cand_xyz, cand_mask, k, _CHUNK, form="elementwise")
        b, n, _ = idx.shape
        neigh = torch.gather(cand_xyz, 1, idx.reshape(b, n * k, 1).expand(b, n * k, 3))
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
        # the same tensor for queries and candidates when they coincide: the
        # K2 wrapper then reuses the candidates' spatial order for the queries
        mom = knn_moments(xyz.contiguous(), mask.contiguous(), cand_xyz.contiguous(),
                          cand_mask.contiguous(), moment_table(cand_xyz, cand_mask).contiguous(), k)
        cov6 = cov6_from_moments(mom, k)
    else:
        raise ValueError(f"unknown selector {selector!r}")
    if method == PLANE:
        cov6 = sym3.plane_regularize(cov6)
    elif method != NONE:
        cov6 = sym3.from_mat(regularize_covariance(sym3.to_mat(cov6), method))
    return torch.where(mask[:, None, :], cov6, sym3.identity_like(cov6))


def estimate_covariances(xyz: torch.Tensor, mask: torch.Tensor, k: int = 20, method: str = PLANE,
                         chunk: int = 512) -> torch.Tensor:
    """Reference-shaped covariances (knn.py:315-324): xyz [..., N, 3], mask
    [..., N] -> [..., N, 3, 3], through `estimate_cov6` (kernel K2 on the
    card). `chunk` is the reference's tile size of its exact selector; K2
    tiles by itself."""
    del chunk
    lead = xyz.shape[:-2]
    cov6 = estimate_cov6(xyz.reshape(-1, *xyz.shape[-2:]), mask.reshape(-1, mask.shape[-1]), k=k,
                         method=method)
    return sym3.to_mat(cov6).reshape(*lead, *cov6.shape[-1:], 3, 3)

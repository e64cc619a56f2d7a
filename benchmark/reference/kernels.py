"""Plain references of the program's two CUDA kernels.

Frozen copy of `knn_moments_torch` (the counting bisection) of
`rolo_tpu_torch/ops/knn_moments.py` and `keyed_matmul_torch` of
`rolo_tpu_torch/ops/voxel_join.py`, as of commit fba7730, importing nothing
of the program. They state what each kernel computes:

- K2 `knn_moments`: for each valid query, the k-th-neighbour radius by 18
  count-bisection steps from sqrt(max valid d2) + 1, membership
  d2 <= r^2, and the sum of the candidates' moment planes over the members;
- K1 `keyed_matmul`: out[b, s, m] = sum over k of values[b, s, k] where
  keys_k[b, k] == keys_m[b, m]; 0 at a sentinel query.

The sums are matrix products; `precision` "highest" runs them in full f32
(TF32 off), "tf32" in TF32: the control that has to fail the comparison.
"""

from __future__ import annotations

import contextlib

import torch

ITERS = 18
INVALID_PACK = 0x7FFFFFFF
_CHUNK_Q = 512
_CHUNK_M = 1024


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Matrix products in full f32 ("highest") or TF32 ("tf32") inside."""
    if precision not in ("highest", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    old = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def _bisect_counting(d2, valid, rmax, k):
    lo = torch.zeros_like(rmax)
    hi = torch.sqrt(rmax) + 1.0
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        cnt = ((d2 <= (mid * mid)[..., None]) & valid).sum(dim=-1)
        small = cnt < k
        lo = torch.where(small, mid, lo)
        hi = torch.where(small, hi, mid)
    return hi


def knn_moments(xyz, mask, cand_xyz, cand_mask, xc, k: int, precision: str = "highest"):
    """xyz [B, Q, 3], mask [B, Q], cand_xyz [B, N, 3], cand_mask [B, N],
    xc [B, S, N] -> [B, S, Q] f32, zero at masked queries."""
    if cand_xyz.shape[1] == 0:
        return xc.new_zeros(xc.shape[0], xc.shape[1], xyz.shape[1])
    valid = cand_mask[:, None, :]
    outs = []
    with matmul_precision(precision):
        for q0 in range(0, xyz.shape[1], _CHUNK_Q):
            qc = xyz[:, q0:q0 + _CHUNK_Q]
            dx = cand_xyz[:, None, :, 0] - qc[:, :, None, 0]
            dy = cand_xyz[:, None, :, 1] - qc[:, :, None, 1]
            dz = cand_xyz[:, None, :, 2] - qc[:, :, None, 2]
            d2 = dx * dx + dy * dy + dz * dz  # no fused multiply-add
            del dx, dy, dz
            rmax = torch.where(valid, d2, 0.0).amax(dim=-1)
            hi = _bisect_counting(d2, valid, rmax, k)
            w = ((d2 <= (hi * hi)[..., None]) & valid).to(xc.dtype)
            outs.append(torch.stack([xc[i] @ w[i].T for i in range(xc.shape[0])]))
    out = torch.cat(outs, dim=-1)
    return out * mask[:, None, :].to(out.dtype)


def keyed_matmul(values, keys_k, keys_m, precision: str = "highest"):
    """values [B, S, K] f32, keys_k [B, K], keys_m [B, M] int32 -> [B, S, M]."""
    outs = []
    with matmul_precision(precision):
        for m0 in range(0, keys_m.shape[-1], _CHUNK_M):
            km = keys_m[:, m0:m0 + _CHUNK_M]
            eq = (keys_k[:, :, None] == km[:, None, :]) & (km != INVALID_PACK)[:, None, :]
            eq = eq.to(values.dtype)
            outs.append(torch.stack([values[i] @ eq[i] for i in range(values.shape[0])]))
    if not outs:
        return values.new_zeros(values.shape[0], values.shape[1], 0)
    return torch.cat(outs, dim=-1)

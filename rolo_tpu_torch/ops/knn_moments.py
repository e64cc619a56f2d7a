"""k-NN neighbourhood moments (kernel K2), torch port of
`rolo_tpu/ops/knn_moments.py`.

For each query: the k-th-neighbour radius by ITERS count-bisection sweeps
from sqrt(max valid d2) + 1, membership d2 <= r^2 (ties in), and the f32 sum
of the candidate moment planes over the members. On the TPU the kernel is
opt-in (an XLA fusion barrier there); on Hopper it is the production
covariance path, because the plain version writes [chunk, N] distance tiles
to device memory while the CUDA kernel (`csrc/knn_moments.cu`) keeps them in
registers and shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_PLANES = 16
ITERS = 18  # bisection sweeps, as the reference's default
_CHUNK = 512  # queries per [B, chunk, N] distance tile in the plain version


def knn_moments_torch(xyz: torch.Tensor, mask: torch.Tensor, cand_xyz: torch.Tensor,
                      cand_mask: torch.Tensor, xc: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: the same bisection over [B, chunk, N] distance tiles.

    xyz [B, Q, 3] and cand_xyz [B, N, 3] with masked slots zeroed by the
    caller; mask [B, Q], cand_mask [B, N] bool; xc [B, S, N] -> [B, S, Q]."""
    if cand_xyz.shape[1] == 0:
        return xc.new_zeros(xc.shape[0], xc.shape[1], xyz.shape[1])
    valid = cand_mask[:, None, :]
    outs = []
    for q0 in range(0, xyz.shape[1], _CHUNK):
        qc = xyz[:, q0:q0 + _CHUNK]
        dx = cand_xyz[:, None, :, 0] - qc[:, :, None, 0]
        dy = cand_xyz[:, None, :, 1] - qc[:, :, None, 1]
        dz = cand_xyz[:, None, :, 2] - qc[:, :, None, 2]
        d2 = dx * dx + dy * dy + dz * dz  # [B, C, N], no fused multiply-add
        del dx, dy, dz
        rmax = torch.where(valid, d2, 0.0).amax(dim=-1)
        lo = torch.zeros_like(rmax)
        hi = torch.sqrt(rmax) + 1.0
        for _ in range(ITERS):
            mid = 0.5 * (lo + hi)
            cnt = ((d2 <= (mid * mid)[..., None]) & valid).sum(dim=-1)
            small = cnt < k
            lo = torch.where(small, mid, lo)
            hi = torch.where(small, hi, mid)
        w = ((d2 <= (hi * hi)[..., None]) & valid).to(xc.dtype)
        outs.append(torch.bmm(xc, w.transpose(1, 2)))
    out = torch.cat(outs, dim=-1)
    return out * mask[:, None, :].to(out.dtype)


def _check(xyz, mask, cand_xyz, cand_mask, xc):
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or cand_xyz.dim() != 3 or cand_xyz.shape[-1] != 3:
        raise ValueError("knn_moments wants xyz [B, Q, 3] and cand_xyz [B, N, 3]")
    b, q, _ = xyz.shape
    n = cand_xyz.shape[1]
    if mask.shape != (b, q) or cand_mask.shape != (b, n) or cand_xyz.shape[0] != b:
        raise ValueError("knn_moments: mask shapes do not match the point sets")
    if xc.dim() != 3 or xc.shape[0] != b or xc.shape[2] != n or xc.shape[1] > MAX_PLANES:
        raise ValueError(f"knn_moments wants xc [B, S<={MAX_PLANES}, N], got {tuple(xc.shape)}")
    if xyz.dtype != torch.float32 or cand_xyz.dtype != torch.float32 or xc.dtype != torch.float32:
        raise TypeError("knn_moments wants f32 points and moment planes")
    if mask.dtype != torch.bool or cand_mask.dtype != torch.bool:
        raise TypeError("knn_moments wants bool masks")
    if len({t.device for t in (xyz, mask, cand_xyz, cand_mask, xc)}) != 1:
        raise ValueError("knn_moments operands lie on different devices")


def knn_moments(xyz: torch.Tensor, mask: torch.Tensor, cand_xyz: torch.Tensor,
                cand_mask: torch.Tensor, xc: torch.Tensor, k: int) -> torch.Tensor:
    """Per-query k-NN-neighbourhood sums of the candidate moment planes.

    xyz [B, Q, 3], mask [B, Q], cand_xyz [B, N, 3], cand_mask [B, N],
    xc [B, S, N] (S <= 16, zero columns at invalid candidates) ->
    [B, S, Q] f32, zero at masked queries. Masked coordinates must be zeroed
    by the caller (estimate_cov6 does). CPU tensors take the plain version;
    CUDA tensors launch the kernel, counted in `knn_moments.launches`."""
    _check(xyz, mask, cand_xyz, cand_mask, xc)
    if xyz.device.type == "cpu":
        return knn_moments_torch(xyz, mask, cand_xyz, cand_mask, xc, k)
    if xyz.device.type != "cuda":
        raise ValueError(f"knn_moments: unsupported device {xyz.device}")
    tensors = (xyz, mask, cand_xyz, cand_mask, xc)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("knn_moments wants contiguous operands")
    b, q, _ = xyz.shape
    n = cand_xyz.shape[1]
    s = xc.shape[1]
    out = torch.empty((b, s, q), dtype=torch.float32, device=xyz.device)
    if b == 0 or q == 0:
        return out
    lib = cuda_build.load("knn_moments")
    fn = lib.rolo_knn_moments
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(xyz.data_ptr(), mask.data_ptr(), cand_xyz.data_ptr(), cand_mask.data_ptr(),
            xc.data_ptr(), out.data_ptr(), b, q, n, s, int(k), ITERS,
            torch.cuda.current_stream(xyz.device).cuda_stream)
    cuda_build.check_launch(rc, "knn_moments")
    knn_moments.launches += 1
    return out


knn_moments.launches = 0

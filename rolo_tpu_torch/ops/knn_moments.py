"""k-NN neighbourhood moments (kernel K2), torch port of
`rolo_tpu/ops/knn_moments.py`.

For each query: the k-th-neighbour radius by ITERS count-bisection steps
from sqrt(max valid d2) + 1, membership d2 <= r^2 (ties in), and the f32 sum
of the candidate moment planes over the members. On the TPU the kernel is
opt-in (an XLA fusion barrier there); on Hopper it is the production
covariance path, because the plain version writes [chunk, N] distance tiles
to device memory while the CUDA kernel (`csrc/knn_moments.cu`) keeps them in
registers and shared memory.

The kernel does not count at every step: it selects the k-th smallest d2
exactly and replays the bisection from it (two sweeps over the candidates
in place of twenty). `knn_moments_select_torch` is that algorithm in plain
torch, which the CPU tests hold to the counting version.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_PLANES = 16
MAX_K = 32  # the kernel's register queue; larger k is refused on the card
ITERS = 18  # bisection steps, as the reference's default
TILE = 64  # candidates per tile, kTile of csrc/knn_moments.cu
_P = ctypes.c_void_p
_CHUNK = 512  # queries per [B, chunk, N] distance tile in the plain versions


def _bisect_counting(d2, valid, rmax, k):
    """The reference's bisection: each step counts the members of mid."""
    lo = torch.zeros_like(rmax)
    hi = torch.sqrt(rmax) + 1.0
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        cnt = ((d2 <= (mid * mid)[..., None]) & valid).sum(dim=-1)
        small = cnt < k
        lo = torch.where(small, mid, lo)
        hi = torch.where(small, hi, mid)
    return hi


def _bisect_replayed(d2, valid, rmax, k):
    """The same steps replayed from the k-th smallest valid d2 (+inf when
    fewer than k are valid): cnt(mid) < k exactly when d2_(k) > mid^2."""
    d2v = torch.where(valid, d2, float("inf"))
    if d2.shape[-1] >= k:
        kth = torch.topk(d2v, k, dim=-1, largest=False).values[..., k - 1]
    else:
        kth = torch.full_like(rmax, float("inf"))
    lo = torch.zeros_like(rmax)
    hi = torch.sqrt(rmax) + 1.0
    for _ in range(ITERS):
        mid = 0.5 * (lo + hi)
        small = kth > mid * mid
        lo = torch.where(small, mid, lo)
        hi = torch.where(small, hi, mid)
    return hi


def _moments(xyz, mask, cand_xyz, cand_mask, xc, k, bisect):
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
        hi = bisect(d2, valid, rmax, k)
        w = ((d2 <= (hi * hi)[..., None]) & valid).to(xc.dtype)
        # one instance at a time: a batched matmul may split its work by the
        # batch size and round an instance differently than alone
        outs.append(torch.stack([xc[i] @ w[i].T for i in range(xc.shape[0])]))
    out = torch.cat(outs, dim=-1)
    return out * mask[:, None, :].to(out.dtype)


def knn_moments_torch(xyz: torch.Tensor, mask: torch.Tensor, cand_xyz: torch.Tensor,
                      cand_mask: torch.Tensor, xc: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: the reference's counting bisection over [B, chunk, N]
    distance tiles.

    xyz [B, Q, 3] and cand_xyz [B, N, 3] with masked slots zeroed by the
    caller; mask [B, Q], cand_mask [B, N] bool; xc [B, S, N] -> [B, S, Q]."""
    return _moments(xyz, mask, cand_xyz, cand_mask, xc, k, _bisect_counting)


def knn_moments_select_torch(xyz: torch.Tensor, mask: torch.Tensor, cand_xyz: torch.Tensor,
                             cand_mask: torch.Tensor, xc: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's algorithm in plain torch: the k-th smallest valid d2 by
    `torch.topk`, the bisection replayed from it, then the same sums. The
    tests hold it to `knn_moments_torch` (the count plane bit for bit); no
    caller of the port uses it."""
    return _moments(xyz, mask, cand_xyz, cand_mask, xc, k, _bisect_replayed)


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


def check_kernel_args(k: int) -> None:
    """What the CUDA kernel takes beyond `_check`: 1 <= k <= MAX_K (its
    register queue). Larger k raises; it never switches to a plain version."""
    if not 1 <= int(k) <= MAX_K:
        raise ValueError(f"knn_moments: the kernel takes 1 <= k <= {MAX_K}, got k={k}")


MORTON_CELL = 0.25  # m; 10 bits a coordinate cover +-128 m
_MASKED_CODE = 0x7FFFFFFF  # after every valid (30-bit) code


def _morton_codes_torch(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    v = torch.arange(1024, dtype=torch.int32, device=xyz.device)
    spread = sum(((v >> i) & 1) << (3 * i) for i in range(10))  # bit i -> bit 3 i
    cell = torch.clamp(torch.floor(xyz * (1.0 / MORTON_CELL)) + 512, 0, 1023).to(torch.int64)
    code = spread[cell[..., 0]] | (spread[cell[..., 1]] << 1) | (spread[cell[..., 2]] << 2)
    return torch.where(mask, code, _MASKED_CODE)


def morton_codes(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, N] int32 Morton codes of MORTON_CELL cells (10 bits a
    coordinate), masked points after every valid code. The plain version
    on CPU tensors, one small kernel on CUDA tensors."""
    if xyz.device.type == "cpu":
        return _morton_codes_torch(xyz, mask)
    code = torch.empty(mask.shape, dtype=torch.int32, device=xyz.device)
    if code.numel() == 0:
        return code
    fn = cuda_build.function("knn_moments", "rolo_morton_codes",
                             [_P] * 3 + [ctypes.c_int, ctypes.c_float, _P])
    cuda_build.check_launch(fn(xyz.contiguous().data_ptr(), mask.contiguous().data_ptr(),
                               code.data_ptr(), code.numel(), MORTON_CELL,
                               torch.cuda.current_stream(xyz.device).cuda_stream), "morton_codes")
    return code


def morton_order(xyz: torch.Tensor, mask: torch.Tensor):
    """(codes, order) [B, N]: each instance's points sorted along a Morton
    curve, masked points last (a stable sort: the same order on every
    call). The kernel's speed depends on this order, its result does not."""
    return torch.sort(morton_codes(xyz, mask), dim=-1, stable=True)


def knn_moments(xyz: torch.Tensor, mask: torch.Tensor, cand_xyz: torch.Tensor,
                cand_mask: torch.Tensor, xc: torch.Tensor, k: int) -> torch.Tensor:
    """Per-query k-NN-neighbourhood sums of the candidate moment planes.

    xyz [B, Q, 3], mask [B, Q], cand_xyz [B, N, 3], cand_mask [B, N],
    xc [B, S, N] (S <= 16, zero columns at invalid candidates) ->
    [B, S, Q] f32, zero at masked queries. Masked coordinates must be zeroed
    by the caller (estimate_cov6 does). CPU tensors take the plain version;
    CUDA tensors launch the kernel (k <= MAX_K), counted in
    `knn_moments.launches`."""
    _check(xyz, mask, cand_xyz, cand_mask, xc)
    if xyz.device.type == "cpu":
        return knn_moments_torch(xyz, mask, cand_xyz, cand_mask, xc, k)
    if xyz.device.type != "cuda":
        raise ValueError(f"knn_moments: unsupported device {xyz.device}")
    check_kernel_args(k)
    if not all(t.is_contiguous() for t in (xyz, mask, xc)):
        raise ValueError("knn_moments wants contiguous operands")
    b, q, _ = xyz.shape
    n = cand_xyz.shape[1]
    s = xc.shape[1]
    out = torch.empty((b, s, q), dtype=torch.float32, device=xyz.device)
    if b == 0 or q == 0:
        return out
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    codes, order = morton_order(cand_xyz, cand_mask)
    # the candidates and their moment planes in that order, the candidates
    # as float4 tiles with each tile's bounding box
    cand = torch.empty((b, n, 4), dtype=torch.float32, device=xyz.device)
    xcs = torch.empty_like(xc)
    cperm = torch.empty((b, n), dtype=torch.int32, device=xyz.device)
    boxes = torch.empty((b, -(-n // TILE), 2, 4), dtype=torch.float32, device=xyz.device)
    if n > 0:
        gather = cuda_build.function("knn_moments", "rolo_knn_moments_gather",
                                     [_P] * 8 + [ctypes.c_int] * 3 + [_P])
        cuda_build.check_launch(gather(cand_xyz.contiguous().data_ptr(),
                                       cand_mask.contiguous().data_ptr(), xc.data_ptr(),
                                       order.data_ptr(), cand.data_ptr(), xcs.data_ptr(),
                                       cperm.data_ptr(), boxes.data_ptr(), b, n, s, stream),
                                "knn_moments gather")
    if xyz.data_ptr() == cand_xyz.data_ptr() and xyz.shape == cand_xyz.shape:
        qperm, qstart = cperm, None  # the queries are the candidates
    else:
        qcodes, qorder = morton_order(xyz, mask)
        qperm = qorder.to(torch.int32)
        qstart = torch.searchsorted(codes, qcodes).to(torch.int32)
    fn = cuda_build.function("knn_moments", "rolo_knn_moments",
                             [_P] * 8 + [ctypes.c_int] * 6 + [_P])
    rc = fn(xyz.data_ptr(), mask.data_ptr(), qperm.data_ptr(),
            None if qstart is None else qstart.data_ptr(), cand.data_ptr(), boxes.data_ptr(),
            xcs.data_ptr(), out.data_ptr(), b, q, n, s, int(k), ITERS, stream)
    cuda_build.check_launch(rc, "knn_moments")
    knn_moments.launches += 1
    return out


knn_moments.launches = 0

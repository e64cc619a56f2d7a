"""Exact k-NN selection in the matmul distance form (kernel K3,
`csrc/knn_select.cu`).

For each query, the k indices of the smallest d = (qq - 2 q.x) + xx over an
instance's points, nearest first, ties to the lower index. `voxel/knn.py`'s
`knn_indices` computes qq and xx with its plain version's torch ops and
launches K3 for CUDA tensors in the matmul form, in place of the plain
version's [B, 512, N] distance tiles and `torch.topk`; the plain version
stays the CPU path and the kernel's oracle on the card. The kernel keeps no
tile in device memory: its points stream through shared memory and each
thread keeps its best k in registers (the design is in the source).

Nothing here builds or loads the kernel at import.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

MAX_K = 64  # kMaxK of csrc/knn_select.cu: the largest register queue
_P = ctypes.c_void_p


def pack_points(pts: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """[B, N, 4] f32 rows (x, y, z, xx) of the kernel's point tiles."""
    return torch.cat([pts, xx[..., None]], dim=-1).contiguous()


def _check(q, qq, pts4, k):
    if q.dim() != 3 or q.shape[-1] != 3 or pts4.dim() != 3 or pts4.shape[-1] != 4:
        raise ValueError("knn_select wants q [B, Q, 3] and points [B, N, 4]")
    b, nq, _ = q.shape
    if qq.shape != (b, nq) or pts4.shape[0] != b:
        raise ValueError("knn_select: qq or the points do not match the queries")
    if any(t.dtype != torch.float32 for t in (q, qq, pts4)):
        raise TypeError("knn_select wants f32 operands")
    if not 1 <= int(k) <= MAX_K:
        raise ValueError(f"knn_select: the kernel takes 1 <= k <= {MAX_K}, got k={k}")
    if pts4.shape[1] < k:
        raise ValueError(f"knn_select: {pts4.shape[1]} points hold no {k} neighbours")
    if not q.is_cuda or any(t.device != q.device for t in (qq, pts4)):
        raise ValueError("knn_select wants its operands on one CUDA device")


def knn_select(q: torch.Tensor, qq: torch.Tensor, pts4: torch.Tensor, k: int) -> torch.Tensor:
    """q [B, Q, 3], qq [B, Q] (|q|^2), pts4 [B, N, 4] (`pack_points`: masked
    coordinates zeroed, xx = +inf there) -> [B, Q, k] int64, launched on the
    current stream and counted in `knn_select.launches`. Where fewer than k
    points are valid the tail takes the lowest-index invalid ones; a query
    whose every d is NaN gets index 0."""
    _check(q, qq, pts4, k)
    b, nq, _ = q.shape
    out = torch.empty((b, nq, k), dtype=torch.int64, device=q.device)
    if b == 0 or nq == 0:
        return out
    q, qq, pts4 = q.contiguous(), qq.contiguous(), pts4.contiguous()
    fn = cuda_build.function("knn_select", "rolo_knn_select", [_P] * 4 + [ctypes.c_int] * 4 + [_P])
    with torch.cuda.device(q.device):  # the kernel sets its launch limit on the current device
        cuda_build.check_launch(fn(q.data_ptr(), qq.data_ptr(), pts4.data_ptr(), out.data_ptr(), b,
                                   nq, pts4.shape[1], int(k),
                                   torch.cuda.current_stream(q.device).cuda_stream), "knn_select")
    knn_select.launches += 1
    return out


knn_select.launches = 0


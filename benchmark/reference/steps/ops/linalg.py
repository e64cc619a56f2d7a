"""Frozen copy of `rolo_tpu_torch/ops/linalg.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

Small batched solves for the LM solvers, torch port of
`rolo_tpu/ops/linalg.py`: the 3x3 adjugate inverse and the unrolled
pivot-free Cholesky, kept as the reference writes them so both packages
round alike."""

from __future__ import annotations

import torch


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, P] for a small K, broadcast like `@`, as K
    products accumulated in order (`torch.addcmul`). cuBLAS picks a batched
    matmul's kernel by the batch count, so on the card `@` may round an
    instance of a batch differently than the same instance alone; this
    gives every instance the same bits whatever the batch."""
    out = a[..., :, :1] * b[..., :1, :]
    for i in range(1, a.shape[-1]):
        out = torch.addcmul(out, a[..., :, i:i + 1], b[..., i:i + 1, :])
    return out


def each(fn, *args):
    """fn over instance b of args (each leading with the same batch dim [B]),
    one call per instance, the results stacked (a tuple of results stacked
    field by field). Each instance gets exactly the ops, and the bits, of
    the unbatched call: the way to batch a product or a LAPACK / cuSOLVER
    call whose kernel cuBLAS or cuSOLVER would pick by the batch count, or
    whose rounding decides a gate or a neighbour (plane fits, k-NN tiles).
    The results are contiguous at every B (a LAPACK or cuSOLVER result may
    be column-major, and a later product rounds by its operands' layout); at
    B = 1 that is the only copy."""
    if args[0].shape[0] == 1:
        outs = [fn(*(a[0] for a in args))]
        stack = (lambda ts: ts[0][None].contiguous())
    else:
        outs = [fn(*items) for items in zip(*args)]
        stack = torch.stack
    if not isinstance(outs[0], tuple):
        return stack(outs)
    fields = [stack(list(field)) for field in zip(*outs)]
    return type(outs[0])(*fields) if hasattr(outs[0], "_fields") else tuple(fields)


def matmul_each(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b one instance of the batch dim [B] at a time (`each`)."""
    return each(torch.matmul, a, b)


SUM_TILES = 32


def fixed_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in two fixed stages: SUM_TILES contiguous tiles,
    then the tiles. torch sizes a reduction's thread blocks (and, on the CPU,
    its thread split) by its number of outputs, so one flat sum per instance
    would round an instance differently in a batch of B than alone; here
    every instance is summed alike whatever B is."""
    pad = (-v.shape[-1]) % SUM_TILES
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    return v.reshape(*v.shape[:-1], SUM_TILES, -1).sum(-1).sum(-1)


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of [..., 3, 3] matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    tiny = torch.where(det < 0, -1e-30, 1e-30)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, tiny, det)
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], dim=-1),
            torch.stack([co10, co11, co12], dim=-1),
            torch.stack([co20, co21, co22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _cholesky_unrolled(h: torch.Tensor, n: int):
    """Lower Cholesky factor of [..., n, n] as an n x n list of [...] tensors."""
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = h[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                l[i][j] = s / l[j][j]
    return l


def cholesky_solve_unrolled(h: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Pivot-free Cholesky solve of [..., n, n] x = [..., n], unrolled to
    scalar ops (linalg.py:50-80)."""
    l = _cholesky_unrolled(h, n)
    y = []
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y.append(s / l[i][i])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def cholesky_solve_unrolled_mat(h: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """`cholesky_solve_unrolled` with a matrix right-hand side: h X = B for
    [..., n, n] h and [..., n, m] B, the trailing m kept vectorized
    (linalg.py:83-110)."""
    l = _cholesky_unrolled(h, n)
    y = []
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - l[i][k][..., None] * y[k]
        y.append(s / l[i][i][..., None])
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i][..., None] * x[k]
        x[i] = s / l[i][i][..., None]
    return torch.stack(x, dim=-2)


def inv_psd_unrolled(h: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of [..., n, n] PSD matrices by the unrolled Cholesky solve
    against the identity (linalg.py:113-117)."""
    eye = torch.eye(n, dtype=h.dtype, device=h.device).expand(h.shape)
    return cholesky_solve_unrolled_mat(h, eye, n)


def solve_psd(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve h x = b for small symmetric positive(-ish) definite h with the
    reference's scale-aware jitter (linalg.py:120-137): adjugate for n=3,
    unrolled Cholesky otherwise (the solvers use n = 3 and 6)."""
    n = h.shape[-1]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    trace = torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)
    jitter = 1e-7 * torch.clamp(trace / n, min=1e-12)
    hj = h + jitter[..., None, None] * eye
    if n == 3:
        return small_matmul(inv3x3(hj), b[..., None])[..., 0]
    return cholesky_solve_unrolled(hj, b, n)

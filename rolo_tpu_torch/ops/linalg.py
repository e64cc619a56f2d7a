"""Small batched solves for the LM solvers, torch port of
`rolo_tpu/ops/linalg.py`: the 3x3 adjugate inverse and the unrolled
pivot-free Cholesky, kept as the reference writes them so both packages
round alike."""

from __future__ import annotations

import torch


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


def cholesky_solve_unrolled(h: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Pivot-free Cholesky solve of [..., n, n] x = [..., n], unrolled to
    scalar ops (linalg.py:50-80)."""
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
        return (inv3x3(hj) @ b[..., None])[..., 0]
    return cholesky_solve_unrolled(hj, b, n)

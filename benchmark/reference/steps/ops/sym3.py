"""Frozen copy of `rolo_tpu_torch/ops/sym3.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

Structure-of-arrays symmetric 3x3 algebra, torch port of
`rolo_tpu/ops/sym3.py`.

A batch of symmetric matrices is six [..., 6, N] component planes in the
order (m00, m01, m02, m11, m12, m22). The closed forms below are the ones
the rot-GICP path needs; each mirrors the reference op for op.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

S00, S01, S02, S11, S12, S22 = range(6)


def from_mat(m: torch.Tensor) -> torch.Tensor:
    """[..., N, 3, 3] symmetric -> [..., 6, N] component planes."""
    comps = [m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]]
    return torch.stack(comps, dim=-2)


def to_mat(s: torch.Tensor) -> torch.Tensor:
    """[..., 6, N] -> [..., N, 3, 3] full symmetric matrices."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    row0 = torch.stack([a, b, c], dim=-1)
    row1 = torch.stack([b, d, e], dim=-1)
    row2 = torch.stack([c, e, f], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matvec(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 6, N] sym @ [..., 3, N] -> [..., 3, N]."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    return torch.stack(
        [
            s[..., S00, :] * x + s[..., S01, :] * y + s[..., S02, :] * z,
            s[..., S01, :] * x + s[..., S11, :] * y + s[..., S12, :] * z,
            s[..., S02, :] * x + s[..., S12, :] * y + s[..., S22, :] * z,
        ],
        dim=-2,
    )


def quad(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v^T S v: [..., 6, N], [..., 3, N] -> [..., N]."""
    return torch.sum(v * matvec(s, v), dim=-2)


def add(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return s + t


def identity_like(s: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """[..., 6, N] identity * scale."""
    out = torch.zeros_like(s)
    out[..., S00, :] = scale
    out[..., S11, :] = scale
    out[..., S22, :] = scale
    return out


def congruence(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """R S R^T over a sym batch [..., 6, N].

    r is [3, 3] or batched [B..., 3, 3] whose batch dims lead s's dims (the
    reference takes one rotation per vmapped instance)."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    extra = (1,) * (a.dim() - (r.dim() - 2))

    def rr(i, j):
        return r[..., i, j].reshape(r.shape[:-2] + extra)

    full = ((a, b, c), (b, d, e), (c, e, f))
    t = [[rr(i, 0) * full[0][j] + rr(i, 1) * full[1][j] + rr(i, 2) * full[2][j]
          for j in range(3)] for i in range(3)]

    def entry(i, j):
        return t[i][0] * rr(j, 0) + t[i][1] * rr(j, 1) + t[i][2] * rr(j, 2)

    return torch.stack(
        [entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2)], dim=-2
    )


def inv(s: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of a sym batch [..., 6, N]."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    tiny = torch.where(det < 0, -1e-30, 1e-30)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, tiny, det)
    return torch.stack([co00, co01, co02, co11, co12, co22], dim=-2) * inv_det[..., None, :]


def eigvals(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lam_min, lam_mid, lam_max), trigonometric closed form."""
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    q = (a + d + f) / 3.0
    aq, dq, fq = a - q, d - q, f - q
    p2 = (aq * aq + dq * dq + fq * fq + 2.0 * (b * b + c * c + e * e)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    b00, b01, b02, b11, b12, b22 = aq / p, b / p, c / p, dq / p, e / p, fq / p
    det_b = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    iso = p2 < 1e-28
    return (torch.where(iso, q, lam_min), torch.where(iso, q, lam_mid),
            torch.where(iso, q, lam_max))


def smallest_eigvec(s: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue [..., 3, N]: the
    largest-norm cross product of rows of (S - lam_min I), with an axis
    fallback for (near-)isotropic input."""
    lam_min, _, _ = eigvals(s)
    a, b, c, d, e, f = (s[..., i, :] for i in range(6))
    m00, m11, m22 = a - lam_min, d - lam_min, f - lam_min

    def cross(u, v):
        return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])

    def norm2(u):
        return u[0] * u[0] + u[1] * u[1] + u[2] * u[2]

    r0, r1, r2 = (m00, b, c), (b, m11, e), (c, e, m22)
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01, n02, n12 = norm2(c01), norm2(c02), norm2(c12)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = [torch.where(best12, c12[i], torch.where(best02, c02[i], c01[i])) for i in range(3)]
    m2 = torch.clamp(
        (m00 * m00 + m11 * m11 + m22 * m22 + 2.0 * (b * b + c * c + e * e)) ** 2, min=1e-30
    )
    degenerate = norm2(v) / m2 < 1e-12
    v = [torch.where(degenerate, 1.0 if i == 0 else 0.0, v[i]) for i in range(3)]
    n = torch.sqrt(torch.clamp(norm2(v), min=1e-30))
    return torch.stack([v[0] / n, v[1] / n, v[2] / n], dim=-2)


def plane_regularize(s: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """PLANE covariance surgery: I - (1 - eps) q0 q0^T with q0 the smallest
    eigenvector (sym3.py:182-193)."""
    q0 = smallest_eigvec(s)
    x, y, z = q0[..., 0, :], q0[..., 1, :], q0[..., 2, :]
    w = 1.0 - eps
    return torch.stack(
        [1.0 - w * x * x, -w * x * y, -w * x * z, 1.0 - w * y * y, -w * y * z, 1.0 - w * z * z],
        dim=-2,
    )

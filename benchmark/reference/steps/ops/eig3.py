"""Frozen copy of `rolo_tpu_torch/ops/eig3.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

Closed-form symmetric 3x3 eigendecomposition, torch port of
`rolo_tpu/ops/eig3.py`.

Eigenvalues come from the trigonometric solution of the characteristic
polynomial, eigenvectors from cross products of the rows of (A - lambda I):
elementwise ops over any batch shape, the same formulas as the reference so
both packages round alike. `torch.linalg.eigh` serves only as the tests'
oracle.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending (eig3.py:22-46)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1) / 3.0
    a_q = a - q[..., None, None] * eye
    p2 = torch.sum(a_q * a_q, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    b = a_q / p[..., None, None]
    det_b = (
        b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
        - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
        + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0])
    )
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    isotropic = p2 < 1e-28  # scalar matrix: all eigenvalues = q
    lam = torch.stack([lam_min, lam_mid, lam_max], dim=-1)
    return torch.where(isotropic[..., None], q[..., None].expand_as(lam), lam)


def _eigenvector(a: torch.Tensor, lam: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Eigenvector for eigenvalue lam: the largest cross product of rows of
    (a - lam I); `fallback` where every cross product vanishes
    (eig3.py:49-68)."""
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    c01 = torch.linalg.cross(m[..., 0, :], m[..., 1, :], dim=-1)
    c02 = torch.linalg.cross(m[..., 0, :], m[..., 2, :], dim=-1)
    c12 = torch.linalg.cross(m[..., 1, :], m[..., 2, :], dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = torch.where(best12[..., None], c12, torch.where(best02[..., None], c02, c01))
    n = torch.sum(v * v, dim=-1)
    m2 = torch.clamp(torch.sum(m * m, dim=(-2, -1)) ** 2, min=1e-30)
    v = torch.where((n / m2 < 1e-12)[..., None], fallback, v)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def _unit(lam: torch.Tensor, axis: int) -> torch.Tensor:
    e = torch.zeros_like(lam)
    e[..., axis] = 1.0
    return e


def eigh3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues [..., 3] ascending, eigenvectors [..., 3, 3] with column
    k the eigenvector of eigenvalue k) for symmetric [..., 3, 3]
    (eig3.py:71-91)."""
    lam = eigvalsh3(a)
    ex = _unit(lam, 0)
    v_max = _eigenvector(a, lam[..., 2], ex)
    parallel = torch.abs(v_max[..., 0]) > 0.9
    fb = torch.where(parallel[..., None], _unit(lam, 1), ex)
    fb = fb - torch.sum(fb * v_max, dim=-1, keepdim=True) * v_max
    v_min = _eigenvector(a, lam[..., 0], fb)
    v_min = v_min - torch.sum(v_min * v_max, dim=-1, keepdim=True) * v_max
    v_min = v_min / torch.clamp(torch.linalg.vector_norm(v_min, dim=-1, keepdim=True), min=1e-30)
    v_mid = torch.linalg.cross(v_max, v_min, dim=-1)
    return lam, torch.stack([v_min, v_mid, v_max], dim=-1)


def spectral_rebuild(a: torch.Tensor,
                     new_vals: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Q diag(new_vals(lam)) Q^T; `new_vals` maps the ascending eigenvalues
    [..., 3] to their replacements (eig3.py:94-99)."""
    lam, q = eigh3(a)
    return torch.einsum("...ij,...j,...kj->...ik", q, new_vals(lam), q)

"""Frozen copy of `rolo_tpu_torch/geometry/se3.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

SE(3) rigid transforms as (R, t) pairs, torch port of
`rolo_tpu/geometry/se3.py`. A product whose left factor is a stack of
transforms is `ops.linalg.small_matmul`, so a batch rounds each instance as
alone; a single left factor keeps torch's matmul, which rounds like the
reference's dot."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.linalg import small_matmul
from . import so3


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b if a.dim() == 2 else small_matmul(a, b)


class SE3(NamedTuple):
    """Batched rigid transform: rot [..., 3, 3], trans [..., 3]."""

    rot: torch.Tensor
    trans: torch.Tensor

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device=None) -> "SE3":
        rot = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        return SE3(rot, torch.zeros(*batch_shape, 3, dtype=dtype, device=device))

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply `other` first)."""
        rot = _mm(self.rot, other.rot)
        trans = (_mm(self.rot, other.trans[..., None]))[..., 0] + self.trans
        return SE3(rot, trans)

    def inverse(self) -> "SE3":
        rt = self.rot.transpose(-1, -2)
        return SE3(rt, -_mm(rt, self.trans[..., None])[..., 0])

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points: [..., 3] (one per transform) or [..., N, 3]."""
        if points.dim() == self.trans.dim():
            return _mm(self.rot, points[..., None])[..., 0] + self.trans
        return _mm(points, self.rot.transpose(-1, -2)) + self.trans[..., None, :]

    def as_matrix(self) -> torch.Tensor:
        """-> [..., 4, 4] homogeneous matrix."""
        m = self.rot.new_zeros(*self.rot.shape[:-2], 4, 4)
        m[..., :3, :3] = self.rot
        m[..., :3, 3] = self.trans
        m[..., 3, 3] = 1.0
        return m

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "SE3":
        return SE3(m[..., :3, :3], m[..., :3, 3])

    @staticmethod
    def from_xyzrpy(vec: torch.Tensor) -> "SE3":
        """[..., 6] (x, y, z, roll, pitch, yaw) -> SE3 (pcl::getTransformation)."""
        return SE3(so3.rpy_to_matrix(vec[..., 3], vec[..., 4], vec[..., 5]), vec[..., :3])

    def to_xyzrpy(self) -> torch.Tensor:
        roll, pitch, yaw = so3.matrix_to_rpy(self.rot)
        return torch.cat([self.trans, torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)


def transform_points(rot: torch.Tensor, trans: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts [N, 3] -> R p + t, broadcast over leading batch dims of (rot, trans)."""
    return pts @ rot.transpose(-1, -2) + trans[..., None, :]


def exp(xi: torch.Tensor) -> SE3:
    """Rotation-first se(3) expmap: xi = [omega, rho] [..., 6] -> SE3 with
    the left-Jacobian V (se3.py:80-106)."""
    omega = xi[..., :3]
    rho = xi[..., 3:]
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    rot = so3.exp(omega)
    omega_hat = so3.skew(omega)
    omega_sq = small_matmul(omega_hat, omega_hat)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(omega_hat.shape)
    a = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0, (theta - torch.sin(theta)) / (safe_sq * theta))
    v = eye + a[..., None, None] * omega_hat + b[..., None, None] * omega_sq
    return SE3(rot, small_matmul(v, rho[..., None])[..., 0])


def log(t: SE3) -> torch.Tensor:
    """Inverse of exp: SE3 -> [..., 6] (omega, rho) (se3.py:109-132)."""
    omega = so3.log(t.rot)
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    omega_hat = so3.skew(omega)
    omega_sq = _mm(omega_hat, omega_hat)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(omega_hat.shape)
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0, (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_sq
    )
    v_inv = eye - 0.5 * omega_hat + cot_term[..., None, None] * omega_sq
    return torch.cat([omega, _mm(v_inv, t.trans[..., None])[..., 0]], dim=-1)


def rigid_align(src: torch.Tensor, dst: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> SE3:
    """Weighted Kabsch: the SE3 minimizing sum w |T(src) - dst|^2 for
    src, dst [N, 3] (se3.py:135-149)."""
    w = torch.ones_like(src[:, 0]) if weights is None else weights.to(src.dtype)
    wsum = torch.clamp(w.sum(), min=1e-9)
    cs = (w[:, None] * src).sum(0) / wsum
    cd = (w[:, None] * dst).sum(0) / wsum
    h = torch.einsum("n,ni,nj->ij", w, src - cs, dst - cd)
    u, _, vt = torch.linalg.svd(h)
    d = torch.linalg.det(vt.T @ u.T)
    s = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    rot = vt.T @ s @ u.T
    return SE3(rot, cd - rot @ cs)

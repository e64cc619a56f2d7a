"""SE(3) rigid transforms as (R, t) pairs, torch port of
`rolo_tpu/geometry/se3.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class SE3(NamedTuple):
    """Batched rigid transform: rot [..., 3, 3], trans [..., 3]."""

    rot: torch.Tensor
    trans: torch.Tensor

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply `other` first)."""
        rot = self.rot @ other.rot
        trans = (self.rot @ other.trans[..., None])[..., 0] + self.trans
        return SE3(rot, trans)

    def inverse(self) -> "SE3":
        rt = self.rot.transpose(-1, -2)
        return SE3(rt, -(rt @ self.trans[..., None])[..., 0])


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
    omega_sq = omega_hat @ omega_hat
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(omega_hat.shape)
    a = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0, (theta - torch.sin(theta)) / (safe_sq * theta))
    v = eye + a[..., None, None] * omega_hat + b[..., None, None] * omega_sq
    return SE3(rot, (v @ rho[..., None])[..., 0])


def log(t: SE3) -> torch.Tensor:
    """Inverse of exp: SE3 -> [..., 6] (omega, rho) (se3.py:109-132)."""
    omega = so3.log(t.rot)
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    omega_hat = so3.skew(omega)
    omega_sq = omega_hat @ omega_hat
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(omega_hat.shape)
    half = 0.5 * theta
    cot_term = torch.where(
        small, 1.0 / 12.0, (1.0 - half * torch.cos(half) / torch.sin(half)) / safe_sq
    )
    v_inv = eye - 0.5 * omega_hat + cot_term[..., None, None] * omega_sq
    return torch.cat([omega, (v_inv @ t.trans[..., None])[..., 0]], dim=-1)

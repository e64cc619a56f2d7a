"""SO(3) primitives, torch port of `rolo_tpu/geometry/so3.py`.

Rotation matrices are [..., 3, 3] acting on column vectors, quaternions
[..., 4] in (w, x, y, z) order, tangent vectors [..., 3]. Every function is
shape-polymorphic over leading batch dims, like the reference.
"""

from __future__ import annotations

import torch

_SMALL = 1e-10  # small-angle series cutoff (so3.py:18)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def exp_quat(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> unit quaternion [..., 4] with the reference's
    small-angle series (so3.py:40-55)."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=_SMALL))
    half = 0.5 * theta
    theta_quad = theta_sq * theta_sq
    imag_series = 0.5 - theta_sq / 48.0 + theta_quad / 3840.0
    real_series = 1.0 - theta_sq / 8.0 + theta_quad / 384.0
    use_series = theta_sq < _SMALL
    imag = torch.where(use_series, imag_series, torch.sin(half) / theta)
    real = torch.where(use_series, real_series, torch.cos(half))
    return torch.cat([real[..., None], imag[..., None] * omega], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4], branch-free
    Shepperd's method canonicalized to w >= 0 (so3.py:70-96)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    qw = torch.clamp(qw, min=1e-12)
    s = 2.0 * torch.sqrt(qw)
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    c0 = torch.stack([s0 / 4.0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    c1 = torch.stack([(m21 - m12) / s1, s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2], dim=-1)
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0], dim=-1)
    best = torch.argmax(qw, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # [..., 4 cand, 4 comp]
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def exp(omega: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    return quat_to_matrix(exp_quat(omega))


def log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] via the quaternion
    (so3.py:104-121)."""
    q = matrix_to_quat(r)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vec = q[..., 1:]
    n2 = torch.sum(vec * vec, dim=-1)
    small = n2 < 1e-14
    vec_norm = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    theta = 2.0 * torch.atan2(vec_norm, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-9), theta / vec_norm)
    return vec * scale[..., None]


def rpy_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll) (pcl::getTransformation convention)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)

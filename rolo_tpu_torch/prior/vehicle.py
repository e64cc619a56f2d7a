"""Vehicle ground-contact pose solver, torch port of `rolo_tpu/prior/vehicle.py`:
Levenberg-Marquardt over (z, roll, pitch) at a fixed (x, y, yaw), with spring
contact forces on the wheels below the ground surface and a gravity-alignment
residual (the reference's VehicleModel / PoseSolver).

The reference maps each wheel with `vmap`; here the wheels are one leading
dimension W. Its `lax.while_loop` is a Python loop with one host check per
iteration. A singular LM system gives non-finite steps in the reference
(`jnp.linalg.solve`); `torch.linalg.solve_ex` neither raises nor syncs, and
its `info` marks the same steps unsolvable.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PriorConfig
from ..geometry import so3
from ..runtime.platform import default_device
from .ground import GroundMap, average_height_at, contact_point, nearest_point_xy


class VehicleModel(NamedTuple):
    """Wheel-contact geometry."""

    wheel_points_body: torch.Tensor  # [W, 3] = (x, y, -com_z)
    com_z: torch.Tensor  # []
    lidar_offset_rot: torch.Tensor  # [3, 3] body -> lidar
    lidar_offset_trans: torch.Tensor  # [3]


def from_config(cfg: PriorConfig, device=None, dtype=torch.float32) -> VehicleModel:
    """The explicit `wheel_xy` list, or four wheels on a square of side
    `vehicle_size_xy` (vehicle.py:40-58)."""
    device = default_device() if device is None else device
    if cfg.wheel_xy:
        xy = torch.tensor(cfg.wheel_xy, dtype=dtype, device=device)
    else:
        half = cfg.vehicle_size_xy / 2.0
        xy = torch.tensor([[-half, half], [half, half], [half, -half], [-half, -half]],
                          dtype=dtype, device=device)
    wheels = torch.cat([xy, torch.full((xy.shape[0], 1), -cfg.vehicle_com_z, dtype=dtype,
                                       device=device)], dim=-1)
    return VehicleModel(
        wheel_points_body=wheels,
        com_z=torch.tensor(cfg.vehicle_com_z, dtype=dtype, device=device),
        lidar_offset_rot=torch.eye(3, dtype=dtype, device=device),
        lidar_offset_trans=torch.tensor(cfg.lidar_offset_trans, dtype=dtype, device=device),
    )


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z]), torch.stack([s, c, z]), torch.stack([z, z, o])])


def _enforce_fixed_yaw(r: torch.Tensor, yaw_fixed: torch.Tensor) -> torch.Tensor:
    """Strip the current yaw and apply the fixed one (vehicle.py:70-74)."""
    return _rot_z(yaw_fixed) @ _rot_z(-torch.atan2(r[1, 0], r[0, 0])) @ r


def _roll_pitch_from_fixed_yaw(r: torch.Tensor, yaw_fixed: torch.Tensor):
    r_tilt = _rot_z(-yaw_fixed) @ r
    return torch.atan2(r_tilt[2, 1], r_tilt[2, 2]), torch.atan2(-r_tilt[2, 0], r_tilt[0, 0])


def _residual_and_jacobian(gm: GroundMap, wheels_b: torch.Tensor, x, y, yaw, z, r, k_spring, g
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """residual [3] = wrench_map @ contact_forces + g (n_w . ez, 0, 0) and
    its Jacobian [3, 3] in (z, roll, pitch) (vehicle.py:85-124), all wheels
    at once."""
    del yaw
    dtype, dev = r.dtype, r.device
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    sx = so3.skew(torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev))
    sy = so3.skew(torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev))
    t = torch.stack([x, y, z])
    n_w = r @ ez  # vehicle normal in world
    # wrench map rows: (1, r_y, -r_x) per wheel
    wmap = torch.stack([torch.ones_like(wheels_b[:, 0]), wheels_b[:, 1], -wheels_b[:, 0]])

    rp = wheels_b @ r.T  # [W, 3]
    pw = rp + t
    a = pw - contact_point(gm, pw[:, :2])
    d_i = a @ n_w
    active = d_i < 0.0
    f = torch.where(active, k_spring * d_i, 0.0)
    act = active.to(dtype) * k_spring
    dfz = act * n_w[2]
    dfr = act * ((rp @ sx.T) @ n_w + a @ (sx @ n_w))
    dfp = act * ((rp @ sy.T) @ n_w + a @ (sy @ n_w))

    zero = torch.zeros_like(n_w[2])
    residual = wmap @ f + g * torch.stack([n_w[2], zero, zero])
    jac = torch.stack([wmap @ dfz, wmap @ dfr, wmap @ dfp], dim=-1)
    gravity = torch.stack([zero, g * torch.dot(ez, sx @ n_w), g * torch.dot(ez, sy @ n_w)])
    jac = torch.cat([(jac[0] + gravity)[None], jac[1:]])
    return residual, jac


class SolverResult(NamedTuple):
    z: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    rot: torch.Tensor  # [3, 3] best rotation (fixed yaw)
    cost: torch.Tensor
    wheel_signed_distances: torch.Tensor  # [W]
    converged: torch.Tensor  # end_reason == "converged"
    success: torch.Tensor  # FailureDetection verdict


def _initial_z(gm: GroundMap, wheels_b, x, y, yaw, com_z, radius, min_neighbors):
    """Lowest averaged wheel ground height + com_z - 1.0, zero when no wheel
    query succeeds (vehicle.py:140-152)."""
    w_xy = (wheels_b @ _rot_z(yaw).T)[:, :2] + torch.stack([x, y])
    h, ok = average_height_at(gm, w_xy, radius, min_neighbors)
    min_h = torch.min(torch.where(ok, h, float("inf")))
    return torch.where(torch.isfinite(min_h), min_h + com_z - 1.0, 0.0)


def _solve3(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a x = b for one 3x3 system: (x, solvable), x zero where unsolvable
    (a singular factorization or a non-finite result), without a host sync."""
    x, info = torch.linalg.solve_ex(a, b)
    solvable = (info == 0) & torch.all(torch.isfinite(x))
    return torch.where(solvable, x, 0.0), solvable


def solve_pose(gm: GroundMap, vehicle: VehicleModel, x, y, yaw,
               cfg: PriorConfig = PriorConfig()) -> SolverResult:
    """PoseSolver::Solve (vehicle.py:155-262): LM with accept/reject steps,
    lambda / 2 on accept and x 5 on reject (x 10 when unsolvable), tracking
    the best-cost iterate; converged on an accepted cost plateau or a step
    below `tol_step`; then the FailureDetection gates."""
    wheels = vehicle.wheel_points_body
    dtype, dev = wheels.dtype, wheels.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    x, y, yaw = scalar(x), scalar(y), scalar(yaw)
    k_spring, g = scalar(cfg.k_spring), scalar(cfg.gravity)
    eye = torch.eye(3, dtype=dtype, device=dev)
    ex, ey = eye[0], eye[1]

    r0 = _rot_z(yaw)
    z0 = _initial_z(gm, wheels, x, y, yaw, vehicle.com_z, cfg.ground_avg_radius,
                    cfg.ground_min_neighbors)
    z, r, lam = z0, r0, scalar(cfg.lm_lambda)
    last_cost = best_cost = scalar(float("inf"))
    best_z, best_r = z0, r0
    conv = torch.tensor(False, device=dev)
    for _ in range(cfg.max_iters):
        res, jac = _residual_and_jacobian(gm, wheels, x, y, yaw, z, r, k_spring, g)
        c0 = torch.dot(res, res)
        better = c0 < best_cost
        best_cost = torch.where(better, c0, best_cost)
        best_z = torch.where(better, z, best_z)
        best_r = torch.where(better, r, best_r)

        delta, solvable = _solve3(jac.T @ jac + lam * eye, -(jac.T @ res))
        z_new = z + delta[0]
        r_new = _enforce_fixed_yaw(so3.exp(ex * delta[1]) @ (so3.exp(ey * delta[2]) @ r), yaw)
        res_new, _ = _residual_and_jacobian(gm, wheels, x, y, yaw, z_new, r_new, k_spring, g)
        c1 = torch.dot(res_new, res_new)

        accept = solvable & (c1 < c0)
        conv = ((accept & (torch.abs(last_cost - c1) < cfg.tol_cost))
                | (solvable & (torch.linalg.vector_norm(delta) < cfg.tol_step)))
        z = torch.where(accept, z_new, z)
        r = torch.where(accept, r_new, r)
        lam = torch.where(~solvable, lam * 10.0,
                          torch.where(accept, torch.clamp(lam / 2.0, min=1e-8), lam * 5.0))
        last_cost = torch.where(accept, c1, c0)
        if bool(conv):
            break

    roll, pitch = _roll_pitch_from_fixed_yaw(best_r, yaw)
    # wheel signed distances at the solution
    pw = wheels @ best_r.T + torch.stack([x, y, best_z])
    dists = (pw - nearest_point_xy(gm, pw[:, :2])) @ (best_r @ eye[2])
    success = (conv & (best_z >= cfg.tolerance_z_min) & (best_z <= cfg.tolerance_z_max)
               & (torch.abs(roll) <= cfg.tolerance_roll) & (torch.abs(pitch) <= cfg.tolerance_pitch)
               & torch.all(torch.abs(dists) <= cfg.tolerance_wheel_distance) & gm.ready)
    return SolverResult(z=best_z, roll=roll, pitch=pitch, rot=best_r, cost=best_cost,
                        wheel_signed_distances=dists, converged=conv, success=success)

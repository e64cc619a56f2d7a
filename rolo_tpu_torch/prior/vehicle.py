"""Vehicle ground-contact pose solver, torch port of `rolo_tpu/prior/vehicle.py`:
Levenberg-Marquardt over (z, roll, pitch) at a fixed (x, y, yaw), with spring
contact forces on the wheels below the ground surface and a gravity-alignment
residual (the reference's VehicleModel / PoseSolver).

The reference maps each wheel with `vmap`; here the wheels are one
dimension W, after an optional batch of B queries. Its `lax.while_loop` is a
Python loop with one host check per iteration, over one iteration
(`_contact_iteration`) of fixed shapes, masked by the instances still
running, under `runtime/replay.py`'s `host_loop`. On the card each
iteration is a replay of a CUDA graph captured at the first call of a key
(`replay.run`), so the host launches none of its ~830 kernels; on the CPU
it runs eagerly. A singular LM system gives non-finite steps in the
reference (`jnp.linalg.solve`) and in the pivoted solve here, which neither
raises nor syncs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import PriorConfig
from ..geometry import so3
from ..ops.linalg import small_matmul
from ..runtime import profiling, replay
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


# Every product and sum below is elementwise in a fixed order (small_matmul),
# and the ground queries run in tiles of a fixed row count: a batched matmul
# picks its kernel, and a reduction its thread blocks, by the batch size, so
# only then does an instance of a batch get the bits it gets alone.
_QUERY_TILE = 16


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return small_matmul(a, v[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return small_matmul(a[..., None, :], b[..., :, None])[..., 0, 0]


def _tiled(fn, xy: torch.Tensor) -> torch.Tensor:
    """fn over the queries xy [..., 2], _QUERY_TILE rows per call (zero rows
    pad the last tile): fn(tile [T, 2]) -> [T, ...]."""
    flat = xy.reshape(-1, 2)
    q = flat.shape[0]
    flat = torch.cat([flat, flat.new_zeros((-q) % _QUERY_TILE, 2)])
    out = torch.cat([fn(t) for t in flat.split(_QUERY_TILE)])[:q]
    return out.reshape(*xy.shape[:-1], *out.shape[1:])


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _enforce_fixed_yaw(r: torch.Tensor, yaw_fixed: torch.Tensor) -> torch.Tensor:
    """Strip the current yaw and apply the fixed one (vehicle.py:70-74)."""
    strip = _rot_z(-torch.atan2(r[..., 1, 0], r[..., 0, 0]))
    return small_matmul(small_matmul(_rot_z(yaw_fixed), strip), r)


def _roll_pitch_from_fixed_yaw(r: torch.Tensor, yaw_fixed: torch.Tensor):
    r_tilt = small_matmul(_rot_z(-yaw_fixed), r)
    return (torch.atan2(r_tilt[..., 2, 1], r_tilt[..., 2, 2]),
            torch.atan2(-r_tilt[..., 2, 0], r_tilt[..., 0, 0]))


def _residual_and_jacobian(gm: GroundMap, wheels_b: torch.Tensor, x, y, z, r, k_spring, g, sx,
                           sy) -> Tuple[torch.Tensor, torch.Tensor]:
    """residual [..., 3] = wrench_map @ contact_forces + g (n_w . ez, 0, 0)
    and its Jacobian [..., 3, 3] in (z, roll, pitch) (vehicle.py:85-124),
    all wheels of all instances at once; sx / sy the skews of the unit x / y
    axes."""
    dtype = r.dtype
    t = torch.stack([x, y, z], dim=-1)
    n_w = r[..., :, 2]  # vehicle normal in world: r @ ez
    # wrench map rows: (1, r_y, -r_x) per wheel
    wmap = torch.stack([torch.ones_like(wheels_b[:, 0]), wheels_b[:, 1], -wheels_b[:, 0]])

    rp = small_matmul(wheels_b, r.transpose(-1, -2))  # [..., W, 3]
    pw = rp + t[..., None, :]
    a = pw - _tiled(lambda q: contact_point(gm, q), pw[..., :2])
    n_b = n_w[..., None, :]
    d_i = _dot(a, n_b)
    active = d_i < 0.0
    f = torch.where(active, k_spring * d_i, 0.0)
    act = active.to(dtype) * k_spring
    sxn, syn = _mv(sx, n_w), _mv(sy, n_w)
    dfz = act * n_w[..., 2:3]
    dfr = act * (_dot(small_matmul(rp, sx.T), n_b) + _dot(a, sxn[..., None, :]))
    dfp = act * (_dot(small_matmul(rp, sy.T), n_b) + _dot(a, syn[..., None, :]))

    zero = torch.zeros_like(n_w[..., 2])
    residual = _mv(wmap, f) + g * torch.stack([n_w[..., 2], zero, zero], dim=-1)
    jac = torch.stack([_mv(wmap, dfz), _mv(wmap, dfr), _mv(wmap, dfp)], dim=-1)
    gravity = torch.stack([zero, g * sxn[..., 2], g * syn[..., 2]], dim=-1)  # g ez . (s n_w)
    jac = torch.cat([(jac[..., 0, :] + gravity)[..., None, :], jac[..., 1:, :]], dim=-2)
    return residual, jac


class SolverResult(NamedTuple):
    """Fields lead with the queries' batch shape (none for one query)."""

    z: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    rot: torch.Tensor  # [..., 3, 3] best rotation (fixed yaw)
    cost: torch.Tensor
    wheel_signed_distances: torch.Tensor  # [..., W]
    converged: torch.Tensor  # end_reason == "converged"
    success: torch.Tensor  # FailureDetection verdict


def _initial_z(gm: GroundMap, wheels_b, x, y, yaw, com_z, radius, min_neighbors):
    """Lowest averaged wheel ground height + com_z - 1.0, zero when no wheel
    query succeeds (vehicle.py:140-152)."""
    w_xy = small_matmul(wheels_b, _rot_z(yaw).transpose(-1, -2))[..., :2] + torch.stack([x, y], -1)[
        ..., None, :]
    h = _tiled(lambda q: average_height_at(gm, q, radius, min_neighbors)[0], w_xy)
    min_h = torch.amin(torch.where(gm.ready, h, float("inf")), dim=-1)
    return torch.where(torch.isfinite(min_h), min_h + com_z - 1.0, 0.0)


def _solve3(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a x = b for [..., 3, 3] systems, as the reference's LU solve
    (vehicle.py:191-193, LAPACK getrf / getrs): Gaussian elimination with
    partial pivoting, row by row, elementwise, so no host sync and a batch
    gives each instance its own bits. Returns (x, solvable), x zero where
    non-finite (a singular a gives a zero pivot). The LM systems of a
    contact solve on sparse ground reach condition numbers near 1e6, where
    the adjugate formula loses every digit; pivoted elimination keeps the
    backward error at f32 round-off."""
    rows = [a[..., i, :] for i in range(3)]
    rhs = [b[..., i] for i in range(3)]
    for k in range(2):
        # the row of the largest |a[i, k]|, i >= k (the first on ties) swaps with row k
        p = torch.argmax(torch.stack([r[..., k].abs() for r in rows[k:]], -1), dim=-1) + k
        pivot_row = rows[k]
        pivot_rhs = rhs[k]
        for j in range(k + 1, 3):
            pick = p == j
            pivot_row = torch.where(pick[..., None], rows[j], pivot_row)
            pivot_rhs = torch.where(pick, rhs[j], pivot_rhs)
            rows[j] = torch.where(pick[..., None], rows[k], rows[j])
            rhs[j] = torch.where(pick, rhs[k], rhs[j])
        rows[k], rhs[k] = pivot_row, pivot_rhs
        inv = 1.0 / rows[k][..., k]
        for i in range(k + 1, 3):
            m = rows[i][..., k] * inv
            rows[i] = rows[i] - m[..., None] * rows[k]
            rhs[i] = rhs[i] - m * rhs[k]
    x2 = rhs[2] / rows[2][..., 2]
    x1 = (rhs[1] - rows[1][..., 2] * x2) / rows[1][..., 1]
    x0 = (rhs[0] - rows[0][..., 2] * x2 - rows[0][..., 1] * x1) / rows[0][..., 0]
    x = torch.stack([x0, x1, x2], -1)
    solvable = torch.all(torch.isfinite(x), dim=-1)
    return torch.where(solvable[..., None], x, 0.0), solvable


class _ContactProblem(NamedTuple):
    """The operands of one contact solve, fixed over its LM loop."""

    xyz: torch.Tensor  # [G, 3] ground map
    mask: torch.Tensor  # [G]
    wheels: torch.Tensor  # [W, 3]
    x: torch.Tensor  # [...] the queries' batch shape
    y: torch.Tensor
    yaw: torch.Tensor
    c: _ContactConsts


class _ContactState(NamedTuple):
    """The contact LM's state between iterations."""

    z: torch.Tensor  # [...]
    r: torch.Tensor  # [..., 3, 3]
    lam: torch.Tensor
    last_cost: torch.Tensor
    best_cost: torch.Tensor
    best_z: torch.Tensor
    best_r: torch.Tensor
    conv: torch.Tensor  # [...] bool


class _ContactConsts(NamedTuple):
    """The constants the iteration reads as tensors, built once a call on
    the device without a host copy."""

    k_spring: torch.Tensor  # []
    g: torch.Tensor  # []
    eye: torch.Tensor  # [3, 3]
    sx: torch.Tensor  # [3, 3] skew of the unit x axis
    sy: torch.Tensor  # [3, 3] skew of the unit y axis


def _consts(cfg: PriorConfig, dtype, dev) -> _ContactConsts:
    eye = torch.eye(3, dtype=dtype, device=dev)
    return _ContactConsts(torch.full((), cfg.k_spring, dtype=dtype, device=dev),
                          torch.full((), cfg.gravity, dtype=dtype, device=dev), eye,
                          so3.skew(eye[0]), so3.skew(eye[1]))


def _contact_iteration(p: _ContactProblem, s: _ContactState, tol: Tuple[float, float]
                       ) -> Tuple[_ContactState, None]:
    """One LM iteration (vehicle.py:170-252) of the instances still running:
    linearize, solve, the trial step's cost, accept or reject. tol is
    (tol_cost, tol_step). Returns the next state and no extra output."""
    gm, c = GroundMap(p.xyz, p.mask), p.c
    tol_cost, tol_step = tol
    run = ~s.conv
    res, jac = _residual_and_jacobian(gm, p.wheels, p.x, p.y, s.z, s.r, c.k_spring, c.g, c.sx,
                                      c.sy)
    c0 = _dot(res, res)
    better = run & (c0 < s.best_cost)
    best_cost = torch.where(better, c0, s.best_cost)
    best_z = torch.where(better, s.z, s.best_z)
    best_r = torch.where(better[..., None, None], s.r, s.best_r)

    jt = jac.transpose(-1, -2)
    delta, solvable = _solve3(small_matmul(jt, jac) + s.lam[..., None, None] * c.eye,
                              -_mv(jt, res))
    z_new = s.z + delta[..., 0]
    r_new = _enforce_fixed_yaw(small_matmul(so3.exp(c.eye[0] * delta[..., 1:2]),
                                            small_matmul(so3.exp(c.eye[1] * delta[..., 2:3]), s.r)),
                               p.yaw)
    res_new, _ = _residual_and_jacobian(gm, p.wheels, p.x, p.y, z_new, r_new, c.k_spring, c.g,
                                        c.sx, c.sy)
    c1 = _dot(res_new, res_new)

    accept = solvable & (c1 < c0)
    conv_now = ((accept & (torch.abs(s.last_cost - c1) < tol_cost))
                | (solvable & (torch.sqrt(_dot(delta, delta)) < tol_step)))
    step = run & accept
    lam = torch.where(run, torch.where(~solvable, s.lam * 10.0, torch.where(
        accept, torch.clamp(s.lam / 2.0, min=1e-8), s.lam * 5.0)), s.lam)
    return _ContactState(z=torch.where(step, z_new, s.z),
                         r=torch.where(step[..., None, None], r_new, s.r), lam=lam,
                         last_cost=torch.where(run, torch.where(accept, c1, c0), s.last_cost),
                         best_cost=best_cost, best_z=best_z, best_r=best_r,
                         conv=s.conv | (run & conv_now)), None


def _running(s: _ContactState) -> torch.Tensor:
    return ~s.conv


def solve_pose(gm: GroundMap, vehicle: VehicleModel, x, y, yaw,
               cfg: PriorConfig = PriorConfig()) -> SolverResult:
    """PoseSolver::Solve (vehicle.py:155-262): LM with accept/reject steps,
    lambda / 2 on accept and x 5 on reject (x 10 when unsolvable), tracking
    the best-cost iterate; converged on an accepted cost plateau or a step
    below `tol_step`; then the FailureDetection gates.

    x, y, yaw are scalars, or [B] for B queries against the one map (the
    reference's vmap, parallel/batch.py): every instance iterates until it
    converges, under a mask, with one host check per iteration for the
    whole batch. An instance gets the same bits in a batch as alone.

    On the card each iteration is a replay of a captured CUDA graph
    (`runtime/replay.py`): the eager loop's kernels in its order, so its bits,
    without a host launch each; on the CPU the iterations run eagerly. The
    tracer counts each solve's iterations (`contact_iterations`) and how
    they ran (`contact_graph_iterations`, `contact_eager_iterations`)."""
    wheels = vehicle.wheel_points_body
    dtype, dev = wheels.dtype, wheels.device

    def tensor(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    # contiguous: one layout whichever queries were scalars, so one captured
    # graph a batch shape
    x, y, yaw = (t.contiguous() for t in torch.broadcast_tensors(tensor(x), tensor(y),
                                                                 tensor(yaw)))

    r0 = _rot_z(yaw)
    z0 = _initial_z(gm, wheels, x, y, yaw, vehicle.com_z, cfg.ground_avg_radius,
                    cfg.ground_min_neighbors)
    inf = torch.full_like(x, float("inf"))
    state = _ContactState(z=z0, r=r0, lam=torch.full_like(x, cfg.lm_lambda), last_cost=inf,
                          best_cost=inf, best_z=z0, best_r=r0,
                          conv=torch.zeros(x.shape, dtype=torch.bool, device=dev))
    problem = _ContactProblem(gm.xyz, gm.mask, wheels, x, y, yaw, _consts(cfg, dtype, dev))
    graphed = wheels.is_cuda
    state, n = replay.run(_contact_iteration, problem, state, (cfg.tol_cost, cfg.tol_step),
                          _running, cfg.max_iters, graphed)
    profiling.count("contact_graph_iterations" if graphed else "contact_eager_iterations", n)
    profiling.count("contact_iterations", n)
    best_z, best_r, conv = state.best_z, state.best_r, state.conv

    roll, pitch = _roll_pitch_from_fixed_yaw(best_r, yaw)
    # wheel signed distances at the solution
    pw = (small_matmul(wheels, best_r.transpose(-1, -2))
          + torch.stack([x, y, best_z], -1)[..., None, :])
    dists = _dot(pw - _tiled(lambda q: nearest_point_xy(gm, q), pw[..., :2]),
                 best_r[..., None, :, 2])
    success = (conv & (best_z >= cfg.tolerance_z_min) & (best_z <= cfg.tolerance_z_max)
               & (torch.abs(roll) <= cfg.tolerance_roll) & (torch.abs(pitch) <= cfg.tolerance_pitch)
               & torch.all(torch.abs(dists) <= cfg.tolerance_wheel_distance, dim=-1) & gm.ready)
    return SolverResult(z=best_z, roll=roll, pitch=pitch, rot=best_r, cost=state.best_cost,
                        wheel_signed_distances=dists, converged=conv, success=success)

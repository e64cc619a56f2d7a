"""Manifold pose error-state Kalman filter, torch port of
`rolo_tpu/filter/eskf.py` (the reference's PoseESEKF): a constant-jerk
18-DoF filter on (pos, SO3 rot, vel, omega, acc, alpha) with iterated
pose-measurement updates.

Tangent layout: [0:3) pos, [3:6) rot (right perturbation R' = R Exp(dtheta)),
[6:9) vel, [9:12) omega, [12:15) acc, [15:18) alpha.

Control flow becomes straight-line torch: `process_measurement` evaluates the
update and selects fields with `torch.where` where the reference branches
with `lax.cond`; `state_propagate`'s `lax.scan` is a masked Python loop with
no host check; the 6x6 gain solve is `torch.linalg.solve_ex`, which neither
raises nor syncs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import FilterConfig
from ..geometry import so3
from ..runtime.platform import default_device

_DOF = 18


class ESKFState(NamedTuple):
    pos: torch.Tensor  # [3]
    rot: torch.Tensor  # [3, 3]
    vel: torch.Tensor  # [3]
    omega: torch.Tensor  # [3]
    acc: torch.Tensor  # [3]
    alpha: torch.Tensor  # [3]
    cov: torch.Tensor  # [18, 18]
    last_time: torch.Tensor  # []
    initialized: torch.Tensor  # [] bool


def _select(cond: torch.Tensor, a: ESKFState, b: ESKFState) -> ESKFState:
    """a where cond else b, field by field."""
    return ESKFState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _initial_cov(cfg: FilterConfig, dtype, device) -> torch.Tensor:
    stds = torch.tensor([cfg.init_position_std, cfg.init_rotation_std, cfg.init_velocity_std,
                         cfg.init_angular_velocity_std, cfg.init_acceleration_std,
                         cfg.init_angular_acceleration_std], dtype=dtype, device=device)
    return torch.diag(torch.repeat_interleave(stds * stds, 3))


def init_filter(cfg: FilterConfig = FilterConfig(), device=None,
                dtype=torch.float32) -> ESKFState:
    device = default_device() if device is None else device
    zero = torch.zeros(3, dtype=dtype, device=device)
    return ESKFState(pos=zero, rot=torch.eye(3, dtype=dtype, device=device), vel=zero,
                     omega=zero, acc=zero, alpha=zero, cov=_initial_cov(cfg, dtype, device),
                     last_time=torch.tensor(0.0, dtype=dtype, device=device),
                     initialized=torch.tensor(False, device=device))


def _initialize(state: ESKFState, stamp, pos, rot, cfg: FilterConfig) -> ESKFState:
    """Hard-set the pose, zero the rates, reset P (eskf.py:85-98)."""
    zero = torch.zeros_like(state.pos)
    return ESKFState(pos=pos, rot=rot, vel=zero, omega=zero, acc=zero, alpha=zero,
                     cov=_initial_cov(cfg, state.pos.dtype, state.pos.device),
                     last_time=stamp, initialized=torch.ones_like(state.initialized))


def _right_jacobian(v: torch.Tensor) -> torch.Tensor:
    """SO(3) right Jacobian Jr(v): Exp(v + d) ~ Exp(v) Exp(Jr(v) d)."""
    theta_sq = torch.sum(v * v, dim=-1)
    small = theta_sq < 1e-10
    safe_sq = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(safe_sq)
    hat = so3.skew(v)
    a = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0, (theta - torch.sin(theta)) / (safe_sq * theta))
    return torch.eye(3, dtype=v.dtype, device=v.device) - a * hat + b * (hat @ hat)


def _predict_mean(state: ESKFState, dt) -> ESKFState:
    """x.oplus(f(x) dt) of the constant-jerk process model."""
    rot_vec = dt * (state.omega + 0.5 * dt * state.alpha)
    return state._replace(pos=state.pos + dt * (state.vel + 0.5 * dt * state.acc),
                          rot=state.rot @ so3.exp(rot_vec), vel=state.vel + dt * state.acc,
                          omega=state.omega + dt * state.alpha)


def predict(state: ESKFState, dt, cfg: FilterConfig) -> ESKFState:
    """One covariance-propagating predict step (eskf.py:126-163): the
    right-perturbation error dynamics, jerk noise on acc / alpha."""
    dtype, dev = state.pos.dtype, state.pos.device
    dt = torch.as_tensor(dt, dtype=dtype, device=dev)
    new = _predict_mean(state, dt)
    eye = torch.eye(3, dtype=dtype, device=dev)
    rot_vec = dt * (state.omega + 0.5 * dt * state.alpha)
    jr = _right_jacobian(rot_vec)
    f = torch.zeros(_DOF, _DOF, dtype=dtype, device=dev)
    for i in range(0, _DOF, 3):
        f[i:i + 3, i:i + 3] = eye
    f[0:3, 6:9] = dt * eye
    f[0:3, 12:15] = 0.5 * dt * dt * eye
    f[3:6, 3:6] = so3.exp(rot_vec).T
    f[3:6, 9:12] = dt * jr
    f[3:6, 15:18] = 0.5 * dt * dt * jr
    f[6:9, 12:15] = dt * eye
    f[9:12, 15:18] = dt * eye
    qlin = (dt * cfg.q_linear_jerk_std) ** 2
    qang = (dt * cfg.q_angular_jerk_std) ** 2
    zero = torch.zeros(12, dtype=dtype, device=dev)
    noise = torch.cat([zero, qlin.expand(3), qang.expand(3)])
    cov = f @ state.cov @ f.T + torch.diag(noise)
    return new._replace(cov=cov, last_time=state.last_time + dt)


def _boxplus(state: ESKFState, dx: torch.Tensor) -> ESKFState:
    return state._replace(pos=state.pos + dx[0:3], rot=state.rot @ so3.exp(dx[3:6]),
                          vel=state.vel + dx[6:9], omega=state.omega + dx[9:12],
                          acc=state.acc + dx[12:15], alpha=state.alpha + dx[15:18])


def _boxminus(a: ESKFState, b: ESKFState) -> torch.Tensor:
    """a [-] b in the tangent at b."""
    return torch.cat([a.pos - b.pos, so3.log(b.rot.T @ a.rot), a.vel - b.vel,
                      a.omega - b.omega, a.acc - b.acc, a.alpha - b.alpha])


def update_iterated(state: ESKFState, meas_pos: torch.Tensor, meas_rot: torch.Tensor,
                    cfg: FilterConfig, r_diag: torch.Tensor = None) -> ESKFState:
    """Iterated EKF pose update (eskf.py:191-235): h(x) = (pos, rot),
    H = [I_6 | 0]; `maximum_iteration` re-linearizations in the tangent of
    the propagated state, delta = K (r_j + H dx_j) - dx_j."""
    dtype, dev = state.pos.dtype, state.pos.device
    if r_diag is None:
        r_diag = torch.tensor([cfg.r_position_std ** 2] * 3 + [cfg.r_rotation_std ** 2] * 3,
                              dtype=dtype, device=dev)
    r_diag = torch.clamp(r_diag, min=1e-12)
    p = state.cov
    s = p[:6, :6] + torch.diag(r_diag)
    k = torch.linalg.solve_ex(s.T, p[:, :6].T)[0].T  # [18, 6] Kalman gain

    x = state
    for _ in range(cfg.maximum_iteration):
        r = torch.cat([meas_pos - x.pos, so3.log(x.rot.T @ meas_rot)])
        dx = _boxminus(x, state)
        x = _boxplus(x, k @ (r + dx[:6]) - dx)
    kh = torch.cat([k, torch.zeros(_DOF, _DOF - 6, dtype=dtype, device=dev)], dim=1)
    return x._replace(cov=(torch.eye(_DOF, dtype=dtype, device=dev) - kh) @ p)


def process_measurement(state: ESKFState, stamp, meas_pos: torch.Tensor, meas_rot: torch.Tensor,
                        cfg: FilterConfig = FilterConfig()) -> Tuple[ESKFState, torch.Tensor]:
    """processMeasurement (eskf.py:238-268): initialize on the first call or
    after a gap over `max_dt`; reject a non-positive or non-finite dt;
    otherwise predict + iterated update. Returns (state, accepted)."""
    stamp = torch.as_tensor(stamp, dtype=state.pos.dtype, device=state.pos.device)
    dt = stamp - state.last_time
    fresh = _initialize(state, stamp, meas_pos, meas_rot, cfg)
    updated = update_iterated(predict(state, dt, cfg), meas_pos, meas_rot, cfg)._replace(
        last_time=stamp)
    too_long = dt > cfg.max_dt
    needs_init = ~state.initialized | too_long
    reject = state.initialized & ((dt <= 0.0) | ~torch.isfinite(dt)) & ~too_long
    out = _select(needs_init, fresh, _select(reject, state, updated))
    return out, ~reject


def state_predict(state: ESKFState, stamp, cfg: FilterConfig = FilterConfig()
                  ) -> Tuple[ESKFState, torch.Tensor]:
    """Dead-reckon to `stamp` without an update (eskf.py:271-283); the state
    is unchanged when uninitialized, dt <= 0 or dt > max_dt."""
    stamp = torch.as_tensor(stamp, dtype=state.pos.dtype, device=state.pos.device)
    dt = stamp - state.last_time
    ok = state.initialized & (dt > 0.0) & torch.isfinite(dt) & (dt <= cfg.max_dt)
    moved = predict(state, torch.where(ok, dt, 0.0), cfg)._replace(last_time=stamp)
    return _select(ok, moved, state), ok


class FutureRollout(NamedTuple):
    pos: torch.Tensor  # [M, 3]
    quat: torch.Tensor  # [M, 4] (w, x, y, z)
    mask: torch.Tensor  # [M] step within the distance budget
    final_index: torch.Tensor  # [] index of the last valid step


def state_propagate(state: ESKFState, cfg: FilterConfig = FilterConfig()) -> FutureRollout:
    """Roll the mean forward in `propagate_step_dt` steps until
    `propagate_horizon_m` of travel (eskf.py:293-322), at the fixed
    `propagate_max_steps` capacity with a mask; a vanishing step ends the
    rollout as in the reference."""
    dt = torch.tensor(cfg.propagate_step_dt, dtype=state.pos.dtype, device=state.pos.device)
    st, alive = state, state.initialized
    dist = torch.zeros_like(dt)
    pos, rots, mask = [], [], []
    for _ in range(cfg.propagate_max_steps):
        nxt = _predict_mean(st, dt)
        step_dis = torch.linalg.vector_norm(nxt.pos - st.pos)
        alive = (alive & torch.isfinite(step_dis) & (step_dis >= 1e-12)
                 & (dist < cfg.propagate_horizon_m))
        dist = dist + torch.where(alive, step_dis, 0.0)
        st = st._replace(pos=torch.where(alive, nxt.pos, st.pos),
                         rot=torch.where(alive, nxt.rot, st.rot),
                         vel=torch.where(alive, nxt.vel, st.vel),
                         omega=torch.where(alive, nxt.omega, st.omega))
        pos.append(st.pos)
        rots.append(st.rot)
        mask.append(alive)
    mask = torch.stack(mask)
    final_index = torch.clamp(mask.sum() - 1, min=0).to(torch.int32)
    return FutureRollout(torch.stack(pos), so3.matrix_to_quat(torch.stack(rots)), mask,
                         final_index)

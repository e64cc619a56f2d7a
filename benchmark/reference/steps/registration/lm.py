"""Frozen copy of `rolo_tpu_torch/registration/lm.py` as of commit fba7730, for the
benchmark's plain reference; it imports nothing of the program.

The original's docstring:

Levenberg-Marquardt solvers for rot-GICP, torch port of
`rolo_tpu/registration/lm.py`: rotation-only SO(3) LM, full SE(3) LM and
Gauss-Newton, and the continuous-time translation LM with rebinding.

The reference runs nested `lax.while_loop`s, one per instance under vmap.
Here each loop is a Python loop up to its static cap over a batch of B
instances, with per-instance masks: an instance whose loop has ended keeps
its state through `torch.where`, exactly as the vmapped select does, so a
batch gives the same result as per-instance runs. The outer loops make one
host check per iteration (`running.any()`) to stop once every instance is
done; the inner lambda trials run to their cap without one.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..geometry import se3, so3
from ..ops.linalg import small_matmul, solve_psd
from . import gicp
from .gicp import Correspondences, GICPContext

MAX_OUTER = 64
MAX_INNER = 10
INIT_LAMBDA_FACTOR = 1e-9
ROTATION_EPS = 2e-3
TRANSFORM_EPS = 5e-4


class LMResult(NamedTuple):
    rot: torch.Tensor  # [B, 3, 3]
    trans: torch.Tensor  # [B, 3]
    hessian: torch.Tensor  # [B, 3, 3]
    error: torch.Tensor  # [B] last linearization error
    iterations: torch.Tensor  # [B] outer iterations executed
    converged: torch.Tensor  # [B] bool
    failed: torch.Tensor  # [B] bool: inner loop exhausted without progress


class CTResult(NamedTuple):
    trans: torch.Tensor  # [B, 3]
    hessian: torch.Tensor  # [B, 6, 6]
    error: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor


def select(mask: torch.Tensor, a, b):
    """Per-instance torch.where over [B, ...] tensors or NamedTuples of them."""
    if isinstance(a, tuple):
        items = [select(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _rot_small(delta_rot: torch.Tensor, rot_eps: float) -> torch.Tensor:
    eye = torch.eye(3, dtype=delta_rot.dtype, device=delta_rot.device)
    return torch.amax(torch.abs(delta_rot - eye), dim=(-2, -1)) / rot_eps < 1.0


def _trans_small(delta_t: torch.Tensor, trans_eps: float) -> torch.Tensor:
    return torch.amax(torch.abs(delta_t), dim=-1) / trans_eps < 1.0


def _lm_inner(h, b, y0, lam, state: Tuple[torch.Tensor, ...], delta0: torch.Tensor,
              try_step: Callable, small_step: Callable, max_inner: int):
    """Batched inner lambda-trial loop (lm.py:56-90): up to max_inner trials,
    each instance stopping at its first accepted (or converged) trial.
    Returns (state, lam, done, delta)."""
    n = h.shape[-1]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    nu = torch.full_like(lam, 2.0)
    done = torch.zeros_like(lam, dtype=torch.bool)
    delta = delta0
    for _ in range(max_inner):
        run = ~done
        d = solve_psd(h + lam[:, None, None] * eye, -b)
        cand, d_delta, yi = try_step(d)
        denom = torch.sum(d * (lam[:, None] * d - b), dim=-1)
        rho = (y0 - yi) / denom
        accept = rho >= 0  # NaN rho (degenerate) rejects
        small = small_step(d_delta)
        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        new_lam = torch.where(accept, lam_acc, nu * lam)
        new_nu = torch.where(accept, nu, 2.0 * nu)
        state = select(run & accept, cand, state)
        lam = torch.where(run, new_lam, lam)
        nu = torch.where(run, new_nu, nu)
        delta = select(run, d_delta, delta)
        done = torch.where(run, accept | small, done)
    return state, lam, done, delta


def _lm_register(bind: Callable, linearize: Callable, error: Callable, retract: Callable,
                 small: Callable, delta0, rot0, trans0, dof: int, max_outer: int, max_inner: int,
                 init_lambda_factor: float, active: Optional[torch.Tensor]) -> LMResult:
    """The shared outer LM loop over (rot, trans) (lm.py:115-145, :164-194):
    bind correspondences, linearize (error, H [B, dof, dof], b [B, dof]),
    lambda trials, convergence on the accepted step's delta. rot0 [B, 3, 3],
    trans0 [B, 3]; instances with active=False do not iterate."""
    bsz = rot0.shape[0]
    dev, dt = rot0.device, rot0.dtype
    running0 = torch.ones(bsz, dtype=torch.bool, device=dev) if active is None else active
    rot, trans = rot0, trans0
    lam = torch.full((bsz,), -1.0, dtype=dt, device=dev)
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    failed = torch.zeros_like(conv)
    h_out = torch.eye(dof, dtype=dt, device=dev).expand(bsz, dof, dof)
    err = torch.zeros(bsz, dtype=dt, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for _ in range(max_outer):
        running = running0 & ~conv & ~failed
        if not bool(running.any()):
            break
        corr = bind(rot, trans)
        y0, h, b = linearize(corr, rot, trans)
        diag_max = torch.amax(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)), dim=-1)
        lam_i = torch.where(lam < 0, init_lambda_factor * diag_max, lam)
        cur_rot, cur_trans = rot, trans

        def try_step(d):
            cand_rot, cand_trans, delta = retract(d, cur_rot, cur_trans)
            return (cand_rot, cand_trans), delta, error(corr, cand_rot, cand_trans)

        (n_rot, n_trans), n_lam, done, delta = _lm_inner(
            h, b, y0, lam_i, (rot, trans), delta0, try_step, small, max_inner)
        rot = select(running, n_rot, rot)
        trans = select(running, n_trans, trans)
        lam = torch.where(running, n_lam, lam)
        conv = torch.where(running, done & small(delta), conv)
        failed = torch.where(running, ~done, failed)
        h_out = select(running, h, h_out)
        err = torch.where(running, y0, err)
        iters = iters + running.to(torch.int32)
    return LMResult(rot, trans, h_out, err, iters, conv, failed)


def _so3_retract(d, rot, trans):
    """Left-multiply the rotation step onto (rot, trans); delta = Exp(d)."""
    delta_rot = so3.exp(d)
    return (small_matmul(delta_rot, rot), small_matmul(delta_rot, trans[..., None])[..., 0],
            delta_rot)


def _se3_retract(d, rot, trans):
    """Left-multiply the SE(3) step; delta = (its rot, its trans)."""
    step = se3.exp(d)
    return (small_matmul(step.rot, rot),
            small_matmul(step.rot, trans[..., None])[..., 0] + step.trans, (step.rot, step.trans))


def _se3_small(rot_eps: float, trans_eps: float) -> Callable:
    def small(delta):
        return _rot_small(delta[0], rot_eps) & _trans_small(delta[1], trans_eps)
    return small


def _se3_delta0(rot0):
    return (torch.eye(3, dtype=rot0.dtype, device=rot0.device).expand_as(rot0),
            torch.zeros(rot0.shape[:-1], dtype=rot0.dtype, device=rot0.device))


def lm_register_rotation(ctx: GICPContext, rot0, trans0, max_outer: int = MAX_OUTER,
                         max_inner: int = MAX_INNER, rot_eps: float = ROTATION_EPS,
                         trans_eps: float = TRANSFORM_EPS,
                         init_lambda_factor: float = INIT_LAMBDA_FACTOR,
                         active: Optional[torch.Tensor] = None, linearize_fn=None,
                         error_fn=None) -> LMResult:
    """SO(3) LM over the rot-GICP objective, rebinding correspondences at
    every outer linearization (lm.py:93-145). rot0 [B, 3, 3], trans0 [B, 3];
    instances with active=False do not iterate and return their start.

    linearize_fn(ctx, corr, rot, trans) -> (error, H, b) and error_fn(ctx,
    corr, rot, trans) -> error replace gicp.so3_linearize / compute_error:
    the point-sharded path (parallel/spmd.py) wraps them in all-reduces, so
    every rank takes the same branches."""
    linearize = linearize_fn if linearize_fn is not None else gicp.so3_linearize
    error = error_fn if error_fn is not None else gicp.compute_error
    eye3 = torch.eye(3, dtype=rot0.dtype, device=rot0.device).expand(rot0.shape[0], 3, 3)
    return _lm_register(
        lambda rot, trans: gicp.update_correspondences(ctx, rot, trans),
        lambda corr, rot, trans: linearize(ctx, corr, rot, trans),
        lambda corr, rot, trans: error(ctx, corr, rot, trans),
        _so3_retract, lambda dr: _rot_small(dr, rot_eps), eye3, rot0, trans0, 3, max_outer,
        max_inner, init_lambda_factor, active)


def lm_register_se3(ctx: GICPContext, rot0, trans0, max_outer: int = MAX_OUTER,
                    max_inner: int = MAX_INNER, rot_eps: float = ROTATION_EPS,
                    trans_eps: float = TRANSFORM_EPS,
                    init_lambda_factor: float = INIT_LAMBDA_FACTOR,
                    active: Optional[torch.Tensor] = None) -> LMResult:
    """Full SE(3) LM (lm.py:148-194): converged when both the rotation and
    the translation of the accepted step are small."""
    return _lm_register(
        lambda rot, trans: gicp.update_correspondences(ctx, rot, trans),
        lambda corr, rot, trans: gicp.se3_linearize(ctx, corr, rot, trans),
        lambda corr, rot, trans: gicp.compute_error(ctx, corr, rot, trans),
        _se3_retract, _se3_small(rot_eps, trans_eps), _se3_delta0(rot0), rot0, trans0, 6,
        max_outer, max_inner, init_lambda_factor, active)


def gn_register_se3(ctx: GICPContext, rot0, trans0, max_outer: int = MAX_OUTER,
                    rot_eps: float = ROTATION_EPS, trans_eps: float = TRANSFORM_EPS,
                    active: Optional[torch.Tensor] = None) -> LMResult:
    """Plain Gauss-Newton SE(3) registration (lm.py:197-233): solve
    H d = -b and always accept; converged on a small step."""
    bsz = rot0.shape[0]
    dev, dt = rot0.device, rot0.dtype
    running0 = torch.ones(bsz, dtype=torch.bool, device=dev) if active is None else active
    small = _se3_small(rot_eps, trans_eps)
    rot, trans = rot0, trans0
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    h_out = torch.eye(6, dtype=dt, device=dev).expand(bsz, 6, 6)
    err = torch.zeros(bsz, dtype=dt, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int32, device=dev)
    for _ in range(max_outer):
        running = running0 & ~conv
        if not bool(running.any()):
            break
        corr = gicp.update_correspondences(ctx, rot, trans)
        y0, h, b = gicp.se3_linearize(ctx, corr, rot, trans)
        n_rot, n_trans, delta = _se3_retract(solve_psd(h, -b), rot, trans)
        rot = select(running, n_rot, rot)
        trans = select(running, n_trans, trans)
        conv = torch.where(running, small(delta), conv)
        h_out = select(running, h, h_out)
        err = torch.where(running, y0, err)
        iters = iters + running.to(torch.int32)
    return LMResult(rot, trans, h_out, err, iters, conv, torch.zeros_like(conv))


def lm_translation(ctx: GICPContext, corr: Correspondences, t0, init_guess, last_t0,
                   interval_tn, interval_tn_1, ct_lambda: float, max_outer: int = MAX_OUTER,
                   max_inner: int = MAX_INNER, trans_eps: float = TRANSFORM_EPS,
                   init_lambda_factor: float = INIT_LAMBDA_FACTOR,
                   active: Optional[torch.Tensor] = None, ct_linearize_fn=None,
                   ct_error_fn=None) -> CTResult:
    """Continuous-time translation NLS on fixed correspondences
    (lm.py:245-306): a 6-dof system of which only the translational part of
    se3_exp(d) is retracted. t0/init_guess/last_t0 [B, 3], intervals [B].
    ct_linearize_fn / ct_error_fn replace gicp.ct_linearize / ct_error, with
    their arguments (the all-reducing wrappers of parallel/spmd.py)."""
    ct_lin = ct_linearize_fn if ct_linearize_fn is not None else gicp.ct_linearize
    ct_err = ct_error_fn if ct_error_fn is not None else gicp.ct_error
    bsz = t0.shape[0]
    dev, dt = t0.device, t0.dtype
    running0 = torch.ones(bsz, dtype=torch.bool, device=dev) if active is None else active
    t = t0
    lam = torch.full((bsz,), -1.0, dtype=dt, device=dev)
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    failed = torch.zeros_like(conv)
    h_out = torch.eye(6, dtype=dt, device=dev).expand(bsz, 6, 6)
    err = torch.zeros(bsz, dtype=dt, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int32, device=dev)
    zero3 = torch.zeros_like(t0)
    args = (init_guess, last_t0, interval_tn, interval_tn_1, ct_lambda)
    for _ in range(max_outer):
        running = running0 & ~conv & ~failed
        if not bool(running.any()):
            break
        y0, h, b = ct_lin(ctx, corr, t, *args)
        diag_max = torch.amax(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)), dim=-1)
        lam_i = torch.where(lam < 0, init_lambda_factor * diag_max, lam)
        cur_t = t

        def try_step(d):
            delta_t = se3.exp(d).trans
            cand = cur_t + delta_t
            return (cand,), delta_t, ct_err(ctx, corr, cand, *args)

        (n_t,), n_lam, done, delta = _lm_inner(
            h, b, y0, lam_i, (t,), zero3, try_step,
            lambda dt_: _trans_small(dt_, trans_eps), max_inner)
        t = select(running, n_t, t)
        lam = torch.where(running, n_lam, lam)
        conv = torch.where(running, done & _trans_small(delta, trans_eps), conv)
        failed = torch.where(running, ~done, failed)
        h_out = select(running, h, h_out)
        err = torch.where(running, y0, err)
        iters = iters + running.to(torch.int32)
    return CTResult(t, h_out, err, iters, conv, failed)


def lm_translation_rebind(ctx: GICPContext, rot, t0, init_guess, last_t0, interval_tn,
                          interval_tn_1, ct_lambda: float, rebind_rounds: int = 4,
                          max_outer: int = MAX_OUTER, max_inner: int = MAX_INNER,
                          trans_eps: float = TRANSFORM_EPS,
                          init_lambda_factor: float = INIT_LAMBDA_FACTOR,
                          active: Optional[torch.Tensor] = None, ct_linearize_fn=None,
                          ct_error_fn=None) -> CTResult:
    """CT translation with correspondence rebinding between rounds
    (lm.py:309-363): re-bind at the current translation and re-solve, up to
    `rebind_rounds` times, each instance stopping once a round no longer
    moves its estimate."""
    bsz = t0.shape[0]
    running0 = torch.ones(bsz, dtype=torch.bool, device=t0.device) if active is None else active

    def do_round(t, act):
        corr = gicp.update_correspondences(ctx, rot, t)
        return lm_translation(ctx, corr, t, init_guess, last_t0, interval_tn, interval_tn_1,
                              ct_lambda, max_outer=max_outer, max_inner=max_inner,
                              trans_eps=trans_eps, init_lambda_factor=init_lambda_factor,
                              active=act, ct_linearize_fn=ct_linearize_fn,
                              ct_error_fn=ct_error_fn)

    res = do_round(t0, running0)
    moved = running0
    for _ in range(1, rebind_rounds):
        if not bool(moved.any()):
            break
        nxt = do_round(res.trans, moved)
        still = torch.amax(torch.abs(nxt.trans - res.trans), dim=-1) > 10.0 * trans_eps
        nxt = nxt._replace(iterations=res.iterations + nxt.iterations)
        res = select(moved, nxt, res)
        moved = moved & still
    return res

"""Levenberg-Marquardt solvers for rot-GICP, torch port of
`rolo_tpu/registration/lm.py`: rotation-only SO(3) LM, full SE(3) LM and
Gauss-Newton, and the continuous-time translation LM with rebinding.

The reference runs nested `lax.while_loop`s, one per instance under vmap.
Here each loop is a Python loop up to its static cap over a batch of B
instances, with per-instance masks: an instance whose loop has ended keeps
its state through `torch.where`, exactly as the vmapped select does, so a
batch gives the same result as per-instance runs. The outer loops make one
host check per iteration (`running.any()`, a `profiling.host_read`) to stop
once every instance is done; the inner lambda trials run to their cap
without one. In an active tracer each LM call counts its outer iterations
and its lambda trials, run and used (`_count_trials`). On the card the CT
translation LM replays each outer iteration as a captured CUDA graph
(`_CTGraph`), so the host launches none of its kernels.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..geometry import se3, so3
from ..ops.linalg import small_matmul, solve_psd
from ..runtime import profiling
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
              try_step: Callable, small_step: Callable, max_inner: int, running: torch.Tensor):
    """Batched inner lambda-trial loop (lm.py:56-90): up to max_inner trials,
    each running instance stopping at its first accepted (or converged)
    trial; the others do not search (their results are not taken).
    Returns (state, lam, done, delta, nu), nu = 2^(1 + the trials each
    instance ran while searching)."""
    n = h.shape[-1]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    nu = torch.full_like(lam, 2.0)
    done = ~running
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
        state = select(run & accept, cand, state)
        lam = torch.where(run, new_lam, lam)
        # nu doubles on each trial run: the next lambda's factor after a
        # rejection; after an acceptance the instance is done and nu unread
        nu = torch.where(run, 2.0 * nu, nu)
        delta = select(run, d_delta, delta)
        done = torch.where(run, accept | small, done)
    return state, lam, done, delta, nu


def _count_trials(iters: torch.Tensor, nus: list, max_inner: int) -> None:
    """An LM call's counters in the active tracer: `lm_iterations`, each
    instance's outer iterations; `lm_trials`, the lambda trials the batch
    ran (max_inner an instance an outer iteration); `lm_trials_used`, those
    each instance ran while searching, from nu = 2^(1 + trials) of every
    outer iteration (`_lm_inner`)."""
    profiling.count("lm_iterations", iters)
    profiling.count("lm_trials", max_inner * iters.numel() * len(nus))
    if nus:
        profiling.count("lm_trials_used",
                        torch.log2(torch.stack(nus)).sum(dim=0).round() - len(nus))


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
    nus = [] if profiling.tracing() else None
    for _ in range(max_outer):
        running = running0 & ~conv & ~failed
        if not profiling.host_read(running.any()):
            break
        corr = bind(rot, trans)
        y0, h, b = linearize(corr, rot, trans)
        diag_max = torch.amax(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)), dim=-1)
        lam_i = torch.where(lam < 0, init_lambda_factor * diag_max, lam)
        cur_rot, cur_trans = rot, trans

        def try_step(d):
            cand_rot, cand_trans, delta = retract(d, cur_rot, cur_trans)
            return (cand_rot, cand_trans), delta, error(corr, cand_rot, cand_trans)

        (n_rot, n_trans), n_lam, done, delta, nu = _lm_inner(
            h, b, y0, lam_i, (rot, trans), delta0, try_step, small, max_inner, running)
        rot = select(running, n_rot, rot)
        trans = select(running, n_trans, trans)
        lam = torch.where(running, n_lam, lam)
        conv = torch.where(running, done & small(delta), conv)
        failed = torch.where(running, ~done, failed)
        h_out = select(running, h, h_out)
        err = torch.where(running, y0, err)
        iters = iters + running.to(torch.int32)
        if nus is not None:
            nus.append(nu)
    if nus is not None:
        _count_trials(iters, nus, max_inner)
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
        if not profiling.host_read(running.any()):
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


class _CTProblem(NamedTuple):
    """The operands of one CT translation solve, fixed over its outer loop."""

    ctx: GICPContext
    corr: Correspondences
    init_guess: torch.Tensor  # [B, 3]
    last_t0: torch.Tensor  # [B, 3]
    interval_tn: torch.Tensor  # [B]
    interval_tn_1: torch.Tensor  # [B]
    running0: torch.Tensor  # [B] bool: the instances that iterate


class _CTState(NamedTuple):
    """The CT translation LM's state between outer iterations."""

    t: torch.Tensor  # [B, 3]
    lam: torch.Tensor  # [B]
    conv: torch.Tensor  # [B] bool
    failed: torch.Tensor  # [B] bool
    h_out: torch.Tensor  # [B, 6, 6]
    err: torch.Tensor  # [B]
    iters: torch.Tensor  # [B] int32
    running: torch.Tensor  # [B] bool: running0 & ~conv & ~failed


class _CTConsts(NamedTuple):
    ct_lambda: float
    max_inner: int
    trans_eps: float
    init_lambda_factor: float


def _ct_iteration(p: _CTProblem, s: _CTState, c: _CTConsts, ct_lin: Callable,
                  ct_err: Callable) -> Tuple[_CTState, torch.Tensor]:
    """One outer iteration of the CT translation LM (lm.py:270-300):
    linearize at s.t, the lambda trials, the running instances' selects.
    Returns the next state and the trials' nu (`_count_trials`)."""
    args = (p.init_guess, p.last_t0, p.interval_tn, p.interval_tn_1, c.ct_lambda)
    y0, h, b = ct_lin(p.ctx, p.corr, s.t, *args)
    diag_max = torch.amax(torch.abs(torch.diagonal(h, dim1=-2, dim2=-1)), dim=-1)
    lam_i = torch.where(s.lam < 0, c.init_lambda_factor * diag_max, s.lam)

    def try_step(d):
        delta_t = se3.exp(d).trans
        cand = s.t + delta_t
        return (cand,), delta_t, ct_err(p.ctx, p.corr, cand, *args)

    running = s.running
    (n_t,), n_lam, done, delta, nu = _lm_inner(
        h, b, y0, lam_i, (s.t,), torch.zeros_like(s.t), try_step,
        lambda dt_: _trans_small(dt_, c.trans_eps), c.max_inner, running)
    conv = torch.where(running, done & _trans_small(delta, c.trans_eps), s.conv)
    failed = torch.where(running, ~done, s.failed)
    return _CTState(select(running, n_t, s.t), torch.where(running, n_lam, s.lam), conv, failed,
                    select(running, h, s.h_out), torch.where(running, y0, s.err),
                    s.iters + running.to(torch.int32), p.running0 & ~conv & ~failed), nu


def _ct_loop(step: Callable, state: _CTState, max_outer: int, nus: Optional[list]):
    """Up to max_outer steps, each after a host check that an instance still
    runs. Returns (the last state, the steps taken)."""
    n = 0
    while n < max_outer and profiling.host_read(state.running.any()):
        state, nu = step(state)
        n += 1
        if nus is not None:
            nus.append(nu)
    return state, n


def _compact(x: torch.Tensor) -> torch.Tensor:
    """x with each expanded (stride-0) dim cut to its one slot."""
    for d in range(x.dim()):
        if x.stride(d) == 0:
            x = x.narrow(d, 0, 1)
    return x


def _operands(p: _CTProblem) -> Tuple[torch.Tensor, ...]:
    """The tensors gicp's CT objective and the loop read: of the context
    only the source points."""
    return (p.ctx.src_t, *p.corr, *p[2:])


class _CTGraph:
    """`_ct_iteration` on gicp's own objective, captured once as a CUDA graph
    over static buffers. The problem's buffers are laid out as the operands
    of the call that captured it, strides included (an expanded dim stays a
    stride-0 view), so every kernel reads what it reads in the eager loop
    and a replay gives the eager loop's bits. Each replay advances the state
    buffers by one outer iteration in place; `nu` is the replay's output."""

    WARMUP = 3

    def __init__(self, p: _CTProblem, s: _CTState, c: _CTConsts):
        ops = _operands(p)
        self.inputs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
                       for x in map(_compact, ops)]
        views = [buf.expand(x.shape) for buf, x in zip(self.inputs, ops)]
        # the objective reads no mask, covariance or map
        ctx = p.ctx._replace(src_t=views[0], src_mask=None, src_cov6=None, vmap=None)
        problem = _CTProblem(ctx, Correspondences(*views[1:4]), *views[4:])
        self.state = _CTState(*(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                                for x in s))
        self.load(p, s)
        dev = s.t.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                _ct_iteration(problem, self.state, c, gicp.ct_linearize, gicp.ct_error)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            nxt, self.nu = _ct_iteration(problem, self.state, c, gicp.ct_linearize,
                                         gicp.ct_error)
            for buf, x in zip(self.state, nxt):
                buf.copy_(x)

    def load(self, p: _CTProblem, s: _CTState) -> None:
        """Copy a call's operands and initial state into the buffers."""
        for buf, x in zip(self.inputs, _operands(p)):
            buf.copy_(_compact(x))
        for buf, x in zip(self.state, s):
            buf.copy_(x)


# captured iterations by (constants, algorithms, operand layouts): each
# configuration's shapes capture once, into the graph's own memory pool
_CT_GRAPHS: dict = {}


def _ct_graphed(p: _CTProblem, s: _CTState, c: _CTConsts, max_outer: int,
                nus: Optional[list]):
    """`_ct_loop` by replays of the key's `_CTGraph`, captured at its first
    use. Returns clones of the state: the buffers are the next call's."""
    key = (c, torch.are_deterministic_algorithms_enabled(),
           tuple((x.shape, x.stride(), x.dtype, x.device) for x in _operands(p)),
           tuple((x.shape, x.dtype) for x in s))
    g = _CT_GRAPHS.get(key)
    if g is None:
        g = _CT_GRAPHS[key] = _CTGraph(p, s, c)
    else:
        g.load(p, s)

    def replay(state):
        g.graph.replay()
        return state, (g.nu if nus is None else g.nu.clone())

    state, n = _ct_loop(replay, g.state, max_outer, nus)
    return _CTState(*(x.clone() for x in state)), n


def _ct_eager(p: _CTProblem, s: _CTState, c: _CTConsts, max_outer: int, nus: Optional[list],
              ct_lin: Optional[Callable] = None, ct_err: Optional[Callable] = None):
    """`_ct_loop` over `_ct_iteration` run eagerly, on the hooks or on
    gicp's own objective."""
    step = functools.partial(_ct_iteration, p, c=c,
                             ct_lin=ct_lin if ct_lin is not None else gicp.ct_linearize,
                             ct_err=ct_err if ct_err is not None else gicp.ct_error)
    return _ct_loop(step, s, max_outer, nus)


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
    their arguments (the all-reducing wrappers of parallel/spmd.py).

    On the card without hooks each outer iteration is a replay of a captured
    CUDA graph (`_CTGraph`): the eager loop's kernels in its order, without
    a host launch each. The eager loop runs on the CPU and under hooks,
    whose collectives are not captured. The tracer counts each path's outer
    iterations (`ct_graph_iterations`, `ct_eager_iterations`)."""
    bsz = t0.shape[0]
    dev, dt = t0.device, t0.dtype
    running0 = torch.ones(bsz, dtype=torch.bool, device=dev) if active is None else active
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    state = _CTState(t0, torch.full((bsz,), -1.0, dtype=dt, device=dev), conv,
                     torch.zeros_like(conv), torch.eye(6, dtype=dt, device=dev).expand(bsz, 6, 6),
                     torch.zeros(bsz, dtype=dt, device=dev),
                     torch.zeros(bsz, dtype=torch.int32, device=dev), running0)
    problem = _CTProblem(ctx, corr, init_guess, last_t0, interval_tn, interval_tn_1, running0)
    consts = _CTConsts(float(ct_lambda), max_inner, trans_eps, init_lambda_factor)
    nus = [] if profiling.tracing() else None
    if t0.is_cuda and ct_linearize_fn is None and ct_error_fn is None:
        state, n = _ct_graphed(problem, state, consts, max_outer, nus)
        profiling.count("ct_graph_iterations", n)
    else:
        state, n = _ct_eager(problem, state, consts, max_outer, nus, ct_linearize_fn,
                             ct_error_fn)
        profiling.count("ct_eager_iterations", n)
    if nus is not None:
        _count_trials(state.iters, nus, max_inner)
    return CTResult(state.t, state.h_out, state.err, state.iters, state.conv, state.failed)


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
        if not profiling.host_read(moved.any()):
            break
        nxt = do_round(res.trans, moved)
        still = torch.amax(torch.abs(nxt.trans - res.trans), dim=-1) > 10.0 * trans_eps
        nxt = nxt._replace(iterations=res.iterations + nxt.iterations)
        res = select(moved, nxt, res)
        moved = moved & still
    return res

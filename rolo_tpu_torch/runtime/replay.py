"""The port's iteration loop, and its replay from captured CUDA graphs.

The iterative solvers (the LM solvers of `registration/lm.py`, the contact
LM of `prior/vehicle.py`) run one iteration of fixed shapes over a batch of
instances, masked by the instances still running, and stop once none runs.
`host_loop` is that loop: before each step one host read
(`profiling.host_read`) of whether any instance still runs, up to a cap.

`run` drives `host_loop` over a module-level iteration
`fn(problem, state, consts, **kw) -> (state, out)`, `out` an extra output
or None. With `graphed` (CUDA tensors, and nothing a graph cannot hold,
such as the point-sharded path's collectives) it calls `replayed`: each
step replays a CUDA graph of one iteration (`CapturedIteration`), captured
at the first call of its key and kept for the process in `_GRAPHS`, so the
host launches none of its kernels. Otherwise it calls `eager`, which calls
the same iteration; tests force the eager path on the card by substituting
`eager` for `replayed`. A replay runs the eager iteration's kernels in its
order on buffers laid out as its operands, strides included, so it gives
the eager loop's bits.

The rule that keeps a replay exact: every tensor the iteration reads is a
leaf of `problem` or `state`, copied into a static buffer at `load`; every
Python value it reads (`fn` itself, `consts`, `kw` and the problem's other
leaves) is in the key (`key`). A per-call closure never enters a key: a new
closure each call would capture a new graph each call. An iteration
therefore reads no tensor through a closure, a default or a global made
per call. Each key captures once, into its graph's own memory pool, and is
never evicted.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import torch

from . import profiling

# captured iterations by `key`
_GRAPHS: dict = {}


def host_loop(step: Callable, state, running: Callable, max_steps: int,
              nus: Optional[list] = None):
    """Up to max_steps steps, each after one host read of whether any
    instance runs (`running(state)`, a [B] bool tensor). step(state) ->
    (state, out); each out is appended to `nus` when it is given. Returns
    (the last state, the steps taken)."""
    n = 0
    while n < max_steps and profiling.host_read(running(state).any()):
        state, out = step(state)
        n += 1
        if nus is not None:
            nus.append(out)
    return state, n


def _leaves(tree) -> list:
    """The leaves of a nest of tuples and NamedTuples, in order."""
    if isinstance(tree, tuple):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _rebuild(tree, tensors: Iterator[torch.Tensor]):
    """tree with its tensor leaves taken in order from `tensors`."""
    if isinstance(tree, tuple):
        items = [_rebuild(item, tensors) for item in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return next(tensors) if isinstance(tree, torch.Tensor) else tree


def _compact(x: torch.Tensor) -> torch.Tensor:
    """x with each expanded (stride-0) dim cut to its one slot."""
    for d in range(x.dim()):
        if x.stride(d) == 0:
            x = x.narrow(d, 0, 1)
    return x


def key(fn: Callable, problem, state, consts, kw: dict) -> tuple:
    """A captured iteration's key: the iteration, its constants and keyword
    arguments, the deterministic-algorithms flag, each problem leaf's shape,
    strides, dtype and device (a non-tensor leaf itself), and each state
    tensor's shape and dtype. key[0] is `fn`."""
    return (fn, consts, tuple(sorted(kw.items())), torch.are_deterministic_algorithms_enabled(),
            tuple((x.shape, x.stride(), x.dtype, x.device) if isinstance(x, torch.Tensor) else x
                  for x in _leaves(problem)),
            tuple((x.shape, x.dtype) for x in _tensors(state)))


class CapturedIteration:
    """`fn` captured once as a CUDA graph over static buffers. The problem's
    buffers take the layouts of the capturing call's operands: an expanded
    dim stays a stride-0 view of one slot, so every kernel reads what it
    reads in the eager loop. Each replay advances the state buffers by one
    iteration in place; `out` is the replay's extra output."""

    WARMUP = 3

    def __init__(self, fn: Callable, problem, state, consts, kw: dict):
        ops = _tensors(problem)
        self.inputs = [torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device)
                       for x in map(_compact, ops)]
        views = _rebuild(problem, (buf.expand(x.shape) for buf, x in zip(self.inputs, ops)))
        self.state = _rebuild(state, (torch.empty(x.shape, dtype=x.dtype, device=x.device)
                                      for x in _tensors(state)))
        self.load(problem, state)
        dev = self.inputs[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn(views, self.state, consts, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            nxt, self.out = fn(views, self.state, consts, **kw)
            for buf, x in zip(_tensors(self.state), _tensors(nxt)):
                buf.copy_(x)

    def load(self, problem, state) -> None:
        """Copy a call's operands and initial state into the buffers."""
        for buf, x in zip(self.inputs, _tensors(problem)):
            buf.copy_(_compact(x))
        for buf, x in zip(_tensors(self.state), _tensors(state)):
            buf.copy_(x)


def replayed(fn: Callable, problem, state, consts, running: Callable, max_steps: int,
             nus: Optional[list], kw: dict):
    """`host_loop` by replays of the key's `CapturedIteration`, captured at
    its first use. Returns clones of the state: the buffers are the next
    call's."""
    k = key(fn, problem, state, consts, kw)
    g = _GRAPHS.get(k)
    if g is None:
        g = _GRAPHS[k] = CapturedIteration(fn, problem, state, consts, kw)
    else:
        g.load(problem, state)

    def step(s):
        g.graph.replay()
        return s, (g.out if nus is None or g.out is None else g.out.clone())

    state, n = host_loop(step, g.state, running, max_steps, nus)
    return _rebuild(state, (x.clone() for x in _tensors(state))), n


def eager(fn: Callable, problem, state, consts, running: Callable, max_steps: int,
          nus: Optional[list], kw: dict):
    """`host_loop` over `fn` called eagerly."""
    return host_loop(lambda s: fn(problem, s, consts, **kw), state, running, max_steps, nus)


def run(fn: Callable, problem, state, consts, running: Callable, max_steps: int, graphed: bool,
        nus: Optional[list] = None, **kw):
    """`host_loop` over fn(problem, state, consts, **kw) -> (state, out):
    `replayed` when `graphed`, else `eager`. Returns (the last state, the
    steps taken)."""
    loop = replayed if graphed else eager
    return loop(fn, problem, state, consts, running, max_steps, nus, kw)

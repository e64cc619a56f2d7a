"""The port's iteration loop and captured iterations
(`rolo_tpu_torch/runtime/replay.py`): `host_loop`'s stops, host reads and
extra outputs, the captured iteration's key, and on the card a replayed
toy iteration against the same iteration run eagerly.

No JAX here: the card's tests run on the GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_replay.py
"""

from typing import NamedTuple

import pytest
import torch

from rolo_tpu_torch.runtime import profiling, replay


class _Problem(NamedTuple):
    a: torch.Tensor  # [B, 4]
    b: torch.Tensor  # [B]
    scale: float


class _State(NamedTuple):
    x: torch.Tensor  # [B]
    n: torch.Tensor  # [B] int32
    running: torch.Tensor  # [B] bool


def _contract(p: _Problem, s: _State, tol: float, shift=0.0):
    """x <- x / 2 + scale * sum(a) * b + shift while the step exceeds tol;
    the extra output is the step."""
    x = s.x * 0.5 + p.scale * p.a.sum(dim=-1) * p.b + shift
    step = torch.abs(x - s.x)
    return _State(torch.where(s.running, x, s.x), s.n + s.running.to(torch.int32),
                  s.running & (step > tol)), step


def _other(p: _Problem, s: _State, tol: float, shift=0.0):
    return _contract(p, s, tol, shift)


def _running(s) -> torch.Tensor:
    return s.running


def _toy(device, x0=(10.0, -3.0, 0.5, 100.0)):
    """A problem with a stride-0 operand (a, expanded over the batch), and a
    start that keeps the instances running for different counts."""
    a = torch.tensor([[0.25, -0.5, 1.0, 0.125]], device=device).expand(len(x0), 4)
    b = torch.linspace(-1.0, 2.0, len(x0), device=device)
    x = torch.tensor(x0, device=device)
    state = _State(x, torch.zeros(len(x0), dtype=torch.int32, device=device),
                   torch.ones(len(x0), dtype=torch.bool, device=device))
    return _Problem(a, b, 0.75), state


def _counter_step(s):
    """x += 1 on the running instances; the extra output is the new sum."""
    x = torch.where(s.running, s.x + 1, s.x)
    return _State(x, s.n + s.running.to(torch.int32), x < 3), x.sum()


def _start(x):
    x = torch.tensor(x)
    return _State(x, torch.zeros_like(x, dtype=torch.int32), x < 3)


@pytest.mark.parametrize("max_steps", [0, 1, 2])
def test_host_loop_stops_at_max_steps(max_steps):
    state, n = replay.host_loop(_counter_step, _start([0, -5]), _running, max_steps)
    assert n == max_steps
    assert state.x.tolist() == [max_steps, max_steps - 5]


@pytest.mark.parametrize("x0,steps", [([0, 1], 3), ([2, 1], 2), ([3, 7], 0)])
def test_host_loop_stops_when_no_instance_runs(x0, steps):
    calls = []

    def step(s):
        calls.append(s)
        return _counter_step(s)

    state, n = replay.host_loop(step, _start(x0), _running, 64)
    assert n == len(calls) == steps
    assert not bool(state.running.any())
    assert state.x.tolist() == [max(v, 3) for v in x0]


@pytest.mark.parametrize("max_steps", [2, 64])
def test_host_loop_reads_once_a_check_and_keeps_the_outputs(max_steps):
    timers = profiling.StageTimers()
    timers.tracing = True
    nus = []
    with timers.stage("s"):
        state, n = replay.host_loop(_counter_step, _start([0, 1]), _running, max_steps, nus)
    assert n == min(max_steps, 3)
    # one read before each step, and one more when no instance ran
    reads = n + (n < max_steps)
    assert timers.summary()["s.host_reads"]["total"] == reads
    assert [int(x) for x in nus] == [1 + 2, 2 + 3, 3 + 3][:n]


def _key(problem, state, fn=_contract, consts=1e-3, kw=None):
    return replay.key(fn, problem, state, consts, kw or {})


def test_the_key_is_equal_for_one_layout():
    p1, s1 = _toy("cpu")
    p2, s2 = _toy("cpu", x0=(1.0, 2.0, 3.0, 4.0))
    p2 = p2._replace(a=(p2.a[:1] + 1.0).expand(4, 4), b=p2.b * 3.0)
    assert _key(p1, s1) == _key(p2, s2)
    assert _key(p1, s1)[0] is _contract
    assert hash(_key(p1, s1)) == hash(_key(p2, s2))


@pytest.mark.parametrize("change", ["stride", "dtype", "deterministic", "fn", "consts", "kw",
                                    "python_leaf", "state_dtype"])
def test_the_key_differs_for_another_layout(change):
    p, s = _toy("cpu")
    want = _key(p, s)
    fn, consts, kw = _contract, 1e-3, {}
    if change == "stride":
        p = p._replace(a=p.a.contiguous())
    elif change == "dtype":
        p = p._replace(b=p.b.double())
    elif change == "fn":
        fn = _other
    elif change == "consts":
        consts = 1e-4
    elif change == "kw":
        kw = {"shift": 1.0}
    elif change == "python_leaf":
        p = p._replace(scale=0.5)
    elif change == "state_dtype":
        s = s._replace(x=s.x.double())
    flag = torch.are_deterministic_algorithms_enabled()
    try:
        if change == "deterministic":
            torch.use_deterministic_algorithms(not flag)
        got = _key(p, s, fn, consts, kw)
    finally:
        torch.use_deterministic_algorithms(flag)
    assert got != want


def test_eager_run_is_the_plain_loop():
    p, s = _toy("cpu")
    got, n = replay.run(_contract, p, s, 1e-3, _running, 64, False, None, shift=0.5)
    state, want_n = s, 0
    while want_n < 64 and bool(state.running.any()):
        state, _ = _contract(p, state, 1e-3, shift=0.5)
        want_n += 1
    assert n == want_n > 1
    assert all(torch.equal(a, b) for a, b in zip(got, state))
    assert len(set(got.n.tolist())) > 1  # the instances stopped apart


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_toy_is_bit_equal_to_eager(cuda, monkeypatch):
    """The replayed iteration against the eager loop: every state field and
    every extra output bit-equal; a second call from another start on the
    same graph gives the eager bits and leaves the first result as it was."""
    monkeypatch.setattr(replay, "_GRAPHS", {})
    p, s = _toy(cuda)
    p2, s2 = _toy(cuda, x0=(-7.0, 0.25, 40.0, 3.0))
    runs = {}
    for name, loop in (("replayed", replay.replayed), ("eager", replay.eager)):
        monkeypatch.setattr(replay, "replayed", loop)
        outs = []
        for problem, state in ((p, s), (p2, s2)):
            nus = []
            got, n = replay.run(_contract, problem, state, 1e-3, _running, 64, True, nus)
            outs.append((got, n, nus, [x.clone() for x in got]))
        runs[name] = outs
    assert len(replay._GRAPHS) == 1
    for (got, n, nus, _), (want, want_n, want_nus, _) in zip(runs["replayed"], runs["eager"]):
        assert n == want_n > 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert len(nus) == n and all(torch.equal(a, b) for a, b in zip(nus, want_nus))
    first, _, _, kept = runs["replayed"][0]
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not torch.equal(runs["replayed"][0][0].x, runs["replayed"][1][0].x)


@pytest.mark.cuda
def test_two_iterations_of_one_layout_get_two_graphs(cuda, monkeypatch):
    graphs = {}
    monkeypatch.setattr(replay, "_GRAPHS", graphs)
    p, s = _toy(cuda)
    for fn in (_contract, _other, _contract):
        replay.run(fn, p, s, 1e-3, _running, 64, True)
    assert sorted(k[0].__name__ for k in graphs) == ["_contract", "_other"]

"""The port's tracer (`rolo_tpu_torch/runtime/profiling.py`): with
`SlamSystem.sync_stages` off a run records the stage times alone and opens
no profiler range; on, it adds the front-end's and the prior cycle's spans
and the counters (LM iterations and trials, the scan-to-map cap, host reads,
scheduler waits), on the profiler's clock, and leaves every pose's bits as
they were. A 12-scan run of the 16-beam simulator at the fixture's
capacities, loops on, so that every stage, span and counter fires.

No JAX here: the clock test also runs on the card
(`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py`)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import small_config, small_sim_kwargs

from rolo_tpu_torch import bench
from rolo_tpu_torch.registration import lm
from rolo_tpu_torch.registration.rotgicp import register_scan_pair
from rolo_tpu_torch.runtime import profiling
from rolo_tpu_torch.runtime.dataset import run_frames
from rolo_tpu_torch.runtime.slam import SlamSystem
from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence

N_SCANS = 12
PROFILED = range(8, N_SCANS)  # two prior cycles and four front-end steps
STAGES = {"ingest", "project+features", "frontend", "backend", "loop_closure", "prior",
          "graph_solve"}
FRONT_SPANS = ("frontend.rotation", "frontend.translation", "frontend.fine")
PRIOR_SPANS = ("prior.predict", "prior.contact")
# `ingest.host_reads` waits for the card's copy event: none on the CPU
COUNTERS = ("frontend.lm_iterations", "frontend.lm_trials", "frontend.lm_trials_used",
            "backend.s2m_capped", "scheduler.wait_scans",
            *(f"{s}.{c}" for s in ("frontend", "backend", "prior", "loop_closure", "graph_solve")
              for c in ("host_reads", "host_wait")))


def _config():
    return small_config(**{"mapping.mapping_process_interval": 0.15, "loop.enable": True,
                           "prior.ground_seg_rings": 16})


def _device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _run(frames, traced: bool):
    """Each scan's published poses, the summary, and the names of the
    profiled scans' host events."""
    slam = SlamSystem(_config(), "cpu")
    slam.sync_stages = traced
    poses, names = [], set()
    for i, f in enumerate(frames):
        if i in PROFILED:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time)
            names |= {e.name() for e in prof.profiler.kineto_results.events()}
        else:
            slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time)
        poses.append(slam.published())
    return poses, slam.timers.summary(), names


@pytest.fixture(scope="module")
def frames():
    return list(generate_sequence(SimConfig(**small_sim_kwargs(N_SCANS)), "cpu"))


@pytest.fixture(scope="module")
def runs(frames):
    return {traced: _run(frames, traced) for traced in (False, True)}


def test_off_records_the_stages_alone_and_opens_no_range(runs):
    _, summary, names = runs[False]
    assert set(summary) == STAGES
    ours = STAGES | set(FRONT_SPANS) | set(PRIOR_SPANS)
    assert not names & ours
    assert not [n for n in names if n.startswith(("frontend.", "prior.", "backend."))]


def test_on_records_every_span_and_counter_inside_its_stage(runs):
    _, summary, names = runs[True]
    assert set(summary) >= STAGES | set(FRONT_SPANS) | set(PRIOR_SPANS) | set(COUNTERS)
    assert names >= set(FRONT_SPANS) | set(PRIOR_SPANS) | {"frontend", "prior"}
    for parent, spans in (("frontend", FRONT_SPANS), ("prior", PRIOR_SPANS)):
        assert sum(summary[s]["total_s"] for s in spans) <= summary[parent]["total_s"]
    for name in COUNTERS:
        c = summary[name]
        assert set(c) == {"count", "mean", "total", "max"} and c["count"] > 0
    # one LM call a sample; the front-end's first scan has nothing to register
    assert summary["frontend.lm_iterations"]["total"] >= N_SCANS - 1
    assert 0 < summary["frontend.lm_trials_used"]["total"] <= summary["frontend.lm_trials"]["total"]
    assert summary["frontend.host_reads"]["total"] >= summary["frontend.lm_iterations"]["total"]
    assert {summary["backend.s2m_capped"]["max"]} <= {0.0, 1.0}


def test_poses_are_bit_identical_on_and_off(runs):
    (off, _, _), (on, _, _) = runs[False], runs[True]
    assert len(off) == len(on) == N_SCANS
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_span_lies_on_the_profilers_clock():
    """A span's range lies between `time.time_ns()` reads around it: the
    profiler's host events are on the Unix-epoch clock."""
    dev = _device()
    timers = profiling.StageTimers()
    timers.tracing = True
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        with timers.stage("outer"):
            before = time.time_ns()
            with profiling.span("outer.inner", sync=lambda: x):
                x = torch.ones(1024, device=dev).cumsum(0)
            after = time.time_ns()
    host = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "outer.inner" and "CUDA" not in str(e.device_type())]
    assert len(host) == 1
    assert before <= host[0].start_ns() <= host[0].start_ns() + host[0].duration_ns() <= after
    assert timers.summary()["outer.inner"]["count"] == 1


@pytest.mark.parametrize("read,value", [(bool, torch.tensor([False, True]).any()),
                                        (torch.Tensor.tolist, torch.tensor([True, False]))])
def test_host_read_returns_the_read_and_counts_it(read, value):
    assert profiling.host_read(value, read) == read(value)
    timers = profiling.StageTimers()
    with timers.stage("s"):  # tracing off: nothing is active
        assert profiling.host_read(value, read) == read(value)
    assert set(timers.summary()) == {"s"}
    timers.tracing = True
    with timers.stage("s"):
        with profiling.span("s.inner"):
            got = profiling.host_read(value, read)
    assert got == read(value) and type(got) is type(read(value))
    s = timers.summary()
    assert s["s.host_reads"] == {"count": 1, "mean": 1.0, "total": 1.0, "max": 1.0}
    assert s["s.host_wait"]["count"] == 1 and s["s.host_wait"]["total"] >= 0.0


def _plain_inner(tally):
    """`_lm_inner` as the reference writes it (every instance searches; nu
    keeps its value on an acceptance), tallying the trials each instance
    runs while the outer loop has it running and it has not stopped."""

    def inner(h, b, y0, lam, state, delta0, try_step, small_step, max_inner, running):
        eye = torch.eye(h.shape[-1], dtype=h.dtype)
        nu = torch.full_like(lam, 2.0)
        done = torch.zeros_like(lam, dtype=torch.bool)
        delta = delta0
        for _ in range(max_inner):
            run = ~done
            tally.append((run & running).sum().item())
            d = lm.solve_psd(h + lam[:, None, None] * eye, -b)
            cand, d_delta, yi = try_step(d)
            rho = (y0 - yi) / torch.sum(d * (lam[:, None] * d - b), dim=-1)
            accept = rho >= 0
            small = small_step(d_delta)
            lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            new_lam = torch.where(accept, lam_acc, nu * lam)
            new_nu = torch.where(accept, nu, 2.0 * nu)
            state = lm.select(run & accept, cand, state)
            lam = torch.where(run, new_lam, lam)
            nu = torch.where(run, new_nu, nu)
            delta = lm.select(run, d_delta, delta)
            done = torch.where(run, accept | small, done)
        return state, lam, done, delta

    return inner


def test_trials_used_match_a_plain_per_trial_count(monkeypatch):
    """On a batch of 2 scan pairs: the counted trials used equal a per-trial
    tally, and the counted inner loop keeps the plain one's results on every
    running instance."""
    cfg = _config()
    clouds, sim = bench.make_features(SimConfig(**small_sim_kwargs(4)), cfg, "cpu")
    src, sm, tgt, tm, _, _ = bench.stack_pairs(clouds, sim, 2, 2)
    real, tally, calls = lm._lm_inner, [], []

    def both(h, b, y0, lam, state, delta0, try_step, small_step, max_inner, running):
        got = real(h, b, y0, lam, state, delta0, try_step, small_step, max_inner, running)
        want = _plain_inner(tally)(h, b, y0, lam, state, delta0, try_step, small_step,
                                   max_inner, running)
        for g, w in zip(got[:4], want):
            g, w = (g, w) if isinstance(g, tuple) else ((g,), (w,))
            for gi, wi in zip(g, w):
                assert torch.equal(gi[running], wi[running])
        calls.append((running.shape[0], int(running.sum())))
        return got

    monkeypatch.setattr(lm, "_lm_inner", both)
    timers = profiling.StageTimers()
    timers.tracing = True
    z = torch.zeros(2, 3)
    dt = torch.full((2,), 0.2)
    with timers.stage("frontend"):
        register_scan_pair(src, sm, tgt, tm, z, z, dt, dt, cfg.registration,
                           cfg.static.max_voxels, 20)
    s = timers.summary()
    assert s["frontend.lm_trials_used"]["total"] == sum(tally) > 0
    assert s["frontend.lm_trials"]["total"] == (cfg.registration.lm_max_inner_iterations
                                                * sum(b for b, _ in calls))
    assert s["frontend.lm_iterations"]["total"] == sum(n for _, n in calls)


def test_summary_keeps_the_timed_keys_and_run_frames_builds_traced(frames):
    slam = SlamSystem(_config(), "cpu")
    slam.sync_stages = True
    res = run_frames(slam, frames[:4])
    summary = slam.timers.summary()
    timed = {k: v for k, v in summary.items() if "mean_ms" in v}
    assert set(res.stage_ms) == set(timed) >= {"frontend", "frontend.fine"}
    for v in timed.values():
        assert set(v) == {"count", "mean_ms", "p50_ms", "p95_ms", "max_ms", "total_s"}
    assert "frontend.lm_iterations" in summary and "total_s" not in summary[
        "frontend.lm_iterations"]
    assert len(slam.timers.report().splitlines()) == 1 + len(timed)

"""`prior_contact_iterations.stream` reads the contact LM's iterations per solve, and
`prior_contact_graph_share.stream` the share of them replayed from a captured graph, from the
prior stage's counters; both read nothing from a program that counts neither (a parent
without them), and on the CPU every iteration runs eagerly."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import drivers, spec
from benchmark.tests.tiny import tiny_cell

ITERS, SHARE = "prior_contact_iterations.stream", "prior_contact_graph_share.stream"
SEED = 2**31 + 8807


def _counter(total, count=1):
    return {"count": count, "mean": total / count, "total": total, "max": total}


@pytest.mark.parametrize("graph,eager,want", [(30.0, None, 100.0), (30.0, 10.0, 75.0),
                                              (None, 12.0, 0.0), (None, None, None),
                                              (0.0, 0.0, None)])
def test_reads_the_replayed_share(graph, eager, want):
    timers = {"prior": {"count": 4, "total_s": 1.0}}
    for kind, total in (("graph", graph), ("eager", eager)):
        if total is not None:
            timers[f"prior.contact_{kind}_iterations"] = _counter(total)
    assert spec.metric_reader(SHARE)({"timers": timers}) == want


@pytest.mark.parametrize("counter,want", [(_counter(120.0, 4), 30.0), (_counter(0.0, 2), 0.0),
                                          (None, None)])
def test_reads_the_iterations_per_solve(counter, want):
    timers = {"prior": {"count": 4, "total_s": 1.0}}
    if counter is not None:
        timers["prior.contact_iterations"] = counter
    assert spec.metric_reader(ITERS)({"timers": timers}) == want


@pytest.mark.parametrize("name", [ITERS, SHARE])
def test_is_a_program_counter_of_both_streams(name):
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[name]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "prior", "scans_per_s", ["vlp32.stream", "m2ud.stream"])
    assert spec.metric_reader(name)({}) is None


def test_a_traced_cpu_stream_runs_every_iteration_eagerly():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = drivers.run_cell(tiny_cell("stream"), SEED, 8.0, True, "cpu", time.perf_counter(),
                               None)
    finally:
        torch.set_num_threads(n)
    trace = out["outcome"].trace
    assert spec.metric_reader(ITERS)(trace) > 0, sorted(trace["timers"])
    assert spec.metric_reader(SHARE)(trace) == 0.0

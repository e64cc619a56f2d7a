"""`knn_select_share.stream` reads the share of `knn_indices` calls served by kernel K3 from the
stages' `knn.*_calls` counters, and `scan2map_bind_ms.stream` the `backend.bind` span per
mapping step; both read nothing from a program that has neither (a parent without them), and on
the CPU every call takes the plain version."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import drivers, spec
from benchmark.tests.tiny import tiny_cell

SHARE, BIND = "knn_select_share.stream", "scan2map_bind_ms.stream"
SEED = 2**31 + 9203


def _counter(total, count=1):
    return {"count": count, "mean": total / count, "total": total, "max": total}


def _span(total_s, count):
    return {"count": count, "mean_ms": 1e3 * total_s / max(count, 1), "total_s": total_s}


@pytest.mark.parametrize("calls,want", [
    ({"backend.knn.kernel_calls": 40.0}, 100.0),
    ({"backend.knn.kernel_calls": 30.0, "loop_closure.knn.kernel_calls": 6.0,
      "prior.knn.plain_calls": 4.0}, 90.0),
    ({"backend.knn.plain_calls": 12.0}, 0.0),
    ({}, None),
    ({"backend.knn.kernel_calls": 0.0, "backend.knn.plain_calls": 0.0}, None),
    ({"backend.knn_calls": 5.0}, None)])
def test_reads_the_kernel_share(calls, want):
    timers = {"backend": _span(1.0, 4), **{k: _counter(v) for k, v in calls.items()}}
    assert spec.metric_reader(SHARE)({"timers": timers}) == want


@pytest.mark.parametrize("bind,steps,want", [
    (_span(0.3, 8), _span(2.0, 4), 75.0), (_span(0.3, 8), None, None), (None, _span(2.0, 4), None),
    (_span(0.0, 0), _span(2.0, 4), None)])
def test_reads_the_bind_time_per_step(bind, steps, want):
    timers = {k: v for k, v in (("backend.bind", bind), ("backend", steps)) if v is not None}
    got = spec.metric_reader(BIND)({"timers": timers})
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name,source", [(SHARE, "program_counter"), (BIND, "program_span")])
def test_is_a_mapping_metric_of_both_streams(name, source):
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[name]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        source, "mapping", "scans_per_s", ["vlp32.stream", "m2ud.stream"])
    assert spec.metric_reader(name)({}) is None


def test_a_traced_cpu_stream_takes_the_plain_selection():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = drivers.run_cell(tiny_cell("stream"), SEED, 8.0, True, "cpu", time.perf_counter(),
                               None)
    finally:
        torch.set_num_threads(n)
    trace = out["outcome"].trace
    assert spec.metric_reader(SHARE)(trace) == 0.0, sorted(trace["timers"])
    assert spec.metric_reader(BIND)(trace) > 0.0
    assert trace["timers"]["backend.bind"]["total_s"] < trace["timers"]["backend"]["total_s"]

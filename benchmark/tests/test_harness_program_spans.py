"""The per-layer metrics that read the program's own spans and counters
(`SlamSystem.sync_stages` on in a traced stream run) each read a finite
number from a traced run of the stream at the CPU's size (`tiny.py`)."""

from __future__ import annotations

import math
import time

import pytest
import torch

from benchmark.harness import drivers, spec
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 4409
# the readers of the spans and counters inside the program's stages
PROGRAM = ["frontend_rotation_ms.stream", "frontend_translation_ms.stream",
           "frontend_fine_ms.stream", "frontend_lm_iterations.stream",
           "frontend_lm_trial_use.stream", "prior_predict_ms.stream", "prior_contact_ms.stream",
           "scan2map_capped_share.stream", "host_reads_per_scan.stream", "host_wait_ms.stream",
           "scheduler_wait_scans.stream"]
# a metric read only when the window dispatched one of these stages
DISPATCHED_BY = {"scheduler_wait_scans.stream": ("loop_closure", "graph_solve")}


@pytest.fixture(scope="module")
def trace():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = drivers.run_cell(tiny_cell("stream"), SEED, 8.0, True, "cpu", time.perf_counter(),
                               None)
    finally:
        torch.set_num_threads(n)
    return out["outcome"].trace


def test_the_readers_are_the_benchmarks_program_metrics():
    per_layer = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}
    for name in PROGRAM:
        m = per_layer[name]
        assert m["source"] in ("program_span", "program_counter")
        assert m["workloads"] == ["vlp32.stream"] and m["moves"] == "scans_per_s"


@pytest.mark.parametrize("metric", PROGRAM)
def test_program_metric_reads_a_traced_run(trace, metric):
    value = spec.metric_reader(metric)(trace)
    timers = trace["timers"]
    if value is None and metric in DISPATCHED_BY:
        # the CPU's window is short: a loop tick (1 Hz of sensor time) may
        # fall after it, or in a profiled scan, whose samples are dropped
        assert not set(DISPATCHED_BY[metric]) & set(timers), sorted(timers)
        return
    assert value is not None and math.isfinite(value), (metric, sorted(timers))

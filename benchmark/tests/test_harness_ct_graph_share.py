"""`frontend_ct_graph_share.stream` reads the share of the CT LMs' outer
iterations that replayed a captured graph from the two counters, and
nothing from a program that counts neither (a parent without them)."""

from __future__ import annotations

import pytest

from benchmark.harness import spec

NAME = "frontend_ct_graph_share.stream"


def _counter(total):
    return {"count": 1, "mean": total, "total": total, "max": total}


@pytest.mark.parametrize("graph,eager,want", [(30.0, None, 100.0), (30.0, 10.0, 75.0),
                                              (None, 12.0, 0.0), (None, None, None),
                                              (0.0, 0.0, None)])
def test_reads_the_replayed_share(graph, eager, want):
    timers = {"frontend": {"count": 4, "total_s": 1.0}}
    for kind, total in (("graph", graph), ("eager", eager)):
        if total is not None:
            timers[f"frontend.ct_{kind}_iterations"] = _counter(total)
    assert spec.metric_reader(NAME)({"timers": timers}) == want


def test_is_a_program_counter_of_the_stream():
    m = {m["name"]: m for m in spec.benchmark_file()["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "front-end", "scans_per_s", ["vlp32.stream"])
    assert spec.metric_reader(NAME)({}) is None

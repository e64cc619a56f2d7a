"""The benchmark finds each configuration, traffic mix, limit file and
metric reader by the name BENCHMARK.json gives, and the file keeps to the
benchmark's contract on names, units and keys."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.harness import spec

BENCH = spec.benchmark_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = spec.load_cell(cell)
    assert c.traffic["driver"] in ("stream", "batch")
    assert c.config["pinned"]
    assert c.limits["pin_mismatches"] == 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    moved = {m["name"] for m in c.end_to_end}
    assert all(m["moves"] in moved for m in c.per_layer)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_by_name(metric):
    read = spec.metric_reader(metric)
    assert read(None) is None
    assert read({}) is None


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        for entry in BENCH[group]:
            assert set(entry) - {"workloads"} == keys, entry
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_file_is_its_own(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        data = json.load(f)
    assert data["source"] == entry["source"] and data["reduced"] == entry["reduced"]
    assert all(os.path.exists(os.path.join(spec.BENCH_DIR, p)) for p in data["yaml"])

"""Set-up compares the RoloConfig that the deployment's YAML gives through
the program's loader with the configuration file's pin, field by field."""

from __future__ import annotations

import dataclasses

import pytest

from benchmark.harness import spec

CONFIGS = [c["name"] for c in spec.benchmark_file()["configs"]]


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_files_match_their_pin(config):
    cell = next(w["name"] for w in spec.benchmark_file()["workloads"] if w["config"] == config)
    c = spec.load_cell(cell)
    assert spec.pin_mismatches(spec.resolve_config(c.config), c.config["pinned"]) == []


@pytest.mark.parametrize("field,value", [("registration.k_correspondences", 10),
                                         ("mapping.mapping_process_interval", 0.3),
                                         ("static.max_feature_points", 4096)])
def test_a_changed_default_is_caught(field, value):
    c = spec.load_cell("vlp32.stream")
    cfg = spec.resolve_config(c.config)
    section, name = field.split(".")
    moved = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section),
                                                                     **{name: value})})
    assert spec.pin_mismatches(moved, c.config["pinned"]) == [field]


def test_a_missing_pin_field_is_caught():
    c = spec.load_cell("vlp32.stream")
    pinned = {k: dict(v) if isinstance(v, dict) else v for k, v in c.config["pinned"].items()}
    del pinned["loop"]["frequency_hz"]
    assert spec.pin_mismatches(spec.resolve_config(c.config), pinned) == ["loop.frequency_hz"]

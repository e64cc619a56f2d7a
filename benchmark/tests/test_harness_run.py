"""A whole run of a cell at the CPU's size (`tiny.py`), the look for a card
skipped: the result line's keys, and `correct` coming out false with the
timed path broken underneath. The controls (TF32 kernels, bfloat16
features) run on the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as runmod
from benchmark.harness import drivers, spec
from benchmark.tests.tiny import tiny_cell

SEED = 2**31 + 977  # above 32 signed bits: a run takes seeds that large
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(traffic, trace=False, variant=None, device="cpu", seconds=3.0):
    cell = tiny_cell(traffic)
    out = drivers.run_cell(cell, SEED, seconds, trace, device, time.perf_counter(), variant)
    return cell, out, runmod.result_line(cell, out, trace, "cpu", 1)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("traffic,trace", [("stream", False), ("stream", True),
                                           ("batch16", False), ("batch16", True)])
def test_result_line_has_the_contract_keys(traffic, trace):
    cell, out, line = _run(traffic, trace)
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell.limits)
    # the plain versions run on the CPU, so the kernels and the features
    # match exactly
    numbers = out["numbers"]
    assert all(v < float("inf") for v in numbers.values()), numbers
    assert numbers["pin_mismatches"] == numbers["features_gap"] == 0
    assert numbers["knn_moments_gap"] == numbers["keyed_sum_gap"] == 0
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    json.dumps(runmod.finite(line), allow_nan=False)


@pytest.mark.parametrize("traffic,variant,number,margin", [
    ("stream", "fault_state_unchanged", "front_err_m", 0.5),
    ("stream", "fault_answer_altered", "map_err_m", 0.5),
    ("stream", "fault_nudged@0.1", "frontend_step_gap_m", 0.05),
    ("batch16", "fault_state_unchanged", "front_err_m", 0.5),
    ("batch16", "fault_answer_altered", "map_err_m", 0.5),
    ("batch16", "fault_half_batch", "front_err_m", 0.5),
    ("batch16", "fault_nudged@0.1", "frontend_step_gap_m", 0.05)])
def test_a_broken_timed_path_is_not_correct(traffic, variant, number, margin):
    _, sound, _ = _run(traffic, seconds=3.0)
    _, out, line = _run(traffic, variant=variant, seconds=3.0)
    assert line["correct"] is False, line["checks"]
    # the fault, not the small sensor's own error, fails it
    assert out["numbers"][number] > sound["numbers"][number] + margin


def test_no_card_no_result():
    out = subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
                          "vlp32.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control computes the kernels in TF32")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["stream", "batch16"])
@pytest.mark.parametrize("variant,numbers", [
    ("control", ("knn_moments_gap", "keyed_sum_gap")),
    ("control_features", ("features_gap",))])
def test_the_control_is_not_correct(card, traffic, variant, numbers):
    from benchmark.harness import platform

    platform.full_f32()
    _, sound, _ = _run(traffic, device=card)
    _, control, line = _run(traffic, variant=variant, device=card)
    assert line["correct"] is False, line["checks"]
    for name in numbers:
        assert control["numbers"][name] > 3 * sound["numbers"][name]

"""The port's measuring tools (tools/torch_bench_latency.py,
torch_bench_pipeline.py, torch_ab_study.py, torch_ab_defaults.py) on the
CPU at the bag fixture's capacities: their reports carry the reference
tools' keys (less the tunnel round-trip ones), the latency percentiles are
the reference's, the 10 Hz pacing behaves under an injected clock, the A/B
variants are the reference's, and every tool refuses to run without a card.
The reference tools are loaded by file (their JAX imports sit inside
main()); the keys of their reports are read from their source."""

import ast
import dataclasses
import functools
import importlib.util
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_parity import REPO, small_config, small_sim_kwargs

from rolo_tpu_torch.mapping.backend import solve_graph_host
from rolo_tpu_torch.ops.pytree import tree_leaves
from rolo_tpu_torch.runtime.dataset import SequenceResult
from rolo_tpu_torch.runtime.profiling import StageTimers
from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence

TOOLS = os.path.join(REPO, "tools")
PORT_TOOLS = ("torch_bench_latency", "torch_bench_pipeline", "torch_ab_study",
              "torch_ab_defaults", "torch_bench_scaling", "torch_bench_weak_2proc")
# the reference's tunnel round-trip compensation, not ported on purpose
RTT_KEYS = {"scan_to_pose_latency_realtime_minus_rtt",
            "scan_to_pose_latency_local_attach_emulated",
            "scan_to_pose_latency_saturated_minus_rtt", "meets_10hz_budget_p99_local_attach",
            "saturated_p99_within_budget_minus_rtt"}
N_FRAMES, WARMUP = 6, 2


@functools.lru_cache(maxsize=None)
def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(TOOLS,
                                                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # a dataclass resolves its module by name
    spec.loader.exec_module(module)
    return module


def _report_keys(name, var):
    """The keys of the dict the reference tool `name` builds as `var`: its
    literal's keys and those assigned later, with each nested literal's
    keys under its own key."""
    tree = ast.parse(open(os.path.join(TOOLS, f"{name}.py")).read())
    keys, nested = set(), {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == var and isinstance(node.value,
                                                                             ast.Dict):
            for k, v in zip(node.value.keys, node.value.values):
                keys.add(k.value)
                if isinstance(v, ast.Dict):
                    nested[k.value] = {kk.value for kk in v.keys}
        elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
              and target.value.id == var):
            keys.add(target.slice.value)
    return keys, nested


def _config():
    # the fixture turns loop closure off, and the simulator lists rings top
    # first, so the default lower half of the 16 rings sees no ground
    return small_config(**{"mapping.mapping_process_interval": 0.15, "loop.enable": True,
                           "prior.ground_seg_rings": 16})


@functools.lru_cache(maxsize=None)
def _frames():
    return list(generate_sequence(SimConfig(**small_sim_kwargs(N_FRAMES)), "cpu"))


def test_percentiles_match_reference():
    ref, port = _load("bench_latency"), _load("torch_bench_latency")
    rng = np.random.default_rng(0)
    for xs in (rng.exponential(0.3, 297), [0.25], rng.uniform(0.0, 2.0, 20)):
        assert port._percentiles(xs) == ref._percentiles(xs)


def test_latency_report_has_the_reference_keys():
    """Both feed modes and a bucket timing through `measure`, without the
    warm pass (a throwaway run of the same `drive`)."""
    tool = _load("torch_bench_latency")
    cfg = _config()
    report, sat, rt = tool.measure(_frames(), cfg, "cpu", warm=False, buckets=(64, 128),
                                   warmup=WARMUP, n_cols=512)
    keys, nested = _report_keys("bench_latency", "report")
    assert set(report) == keys - RTT_KEYS
    assert set(report["workload"]) == nested["workload"]
    for mode in ("scan_to_pose_latency_realtime_10hz", "scan_to_pose_latency_saturated"):
        assert set(report[mode]) == nested[mode]
        assert report[mode]["all"]["n"] == N_FRAMES - WARMUP
        assert np.isfinite(report[mode]["all"]["max_ms"])
    assert rt.early_starts == 0 and sat.early_starts == 0
    assert np.isfinite(report["ate_rmse_m"]) and report["ate_rmse_m"] < 0.5
    assert list(report["graph_solve_synced_ms_by_bucket"]) == ["64"]  # 128 > the capacity
    assert report["budget_ms"] == 1000.0 * cfg.sensor.scan_period
    assert report["machine"]["platform"] == "cpu"


def test_bucket_timing_starts_every_solve_from_the_state():
    """solve_graph_host writes the keyframe poses in place; the timings
    must leave the state they time as it was."""
    tool = _load("torch_bench_latency")
    cfg = _config()
    from rolo_tpu_torch.runtime.slam import SlamSystem

    slam = SlamSystem(cfg, "cpu")
    for frame in _frames()[:3]:
        slam.process_scan(frame.points, frame.stamp, ring=frame.ring, rel_time=frame.rel_time)
    state = slam.backend_state
    before = [t.clone() for t in tree_leaves(state)]
    assert int(state.db.count) >= 1
    ms = tool.solve_ms_by_bucket(state, cfg, buckets=(64,), reps=2)
    assert set(ms) == {"64"} and ms["64"] > 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    solve_graph_host(state, cfg)  # the state still solves


class _Clock:
    def __init__(self):
        self.now = 0.0
        self.sleeps = 0

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.sleeps += 1
        self.now += seconds


class _Stub:
    """A system that takes `cost` seconds of the injected clock a scan."""

    def __init__(self, clock, cost):
        self.clock, self.cost, self.timers = clock, cost, StageTimers()

    def process_scan(self, points, stamp, ring=None, rel_time=None):
        self.clock.now += self.cost
        return {}

    def published(self):
        return {"fused_trans": np.zeros(3, np.float32)}

    def finalize(self):
        pass


@pytest.mark.parametrize("periods,growth", [(3.0, 2.0), (0.5, 0.0)])
def test_10hz_pacing_builds_the_backlog_it_should(periods, growth):
    """A scan that takes 3 periods makes each latency 2 periods longer than
    the last (it waits for all earlier scans); half a period leaves none."""
    tool = _load("torch_bench_latency")
    period, n = 0.1, 12
    clock = _Clock()
    frames = [SimpleNamespace(points=None, stamp=period * i, gt_trans=np.array([i, 0.0, 0.0]))
              for i in range(n)]
    d = tool.drive(_Stub(clock, periods * period), frames, realtime_period=period, warmup=3,
                   clock=clock, sleep=clock.sleep)
    lat = np.asarray(d.lat_all)
    assert len(lat) == n - 3 and d.early_starts == 0
    np.testing.assert_allclose(lat[0], periods * period, rtol=1e-9)
    np.testing.assert_allclose(np.diff(lat), growth * period, atol=1e-9)
    assert (clock.sleeps > 0) == (periods < 1.0)  # never sleeps past a passed arrival
    assert len(d.spikes) == int((lat > tool.SPIKE_S).sum())


def test_pipeline_report_has_the_reference_keys():
    tool = _load("torch_bench_pipeline")
    out = tool.run(_frames(), _config(), WARMUP, synced=True, device="cpu")
    keys, _ = _report_keys("bench_pipeline", "out")
    assert set(out) - {"frontend_flops_scope"} == keys
    assert out["n_scans_measured"] == N_FRAMES - WARMUP and out["value"] > 0
    assert out["frontend_flops_per_step"] > 0 and out["frontend_device_ms"] > 0
    assert out["peak_tflops_assumed"] == 67.0 and out["synced_stage_timing"] is True
    assert {"frontend", "backend"} <= set(out["stage_mean_ms"])
    assert out["ate_frontend_rmse_m"] < 0.5 and out["n_keyframes"] >= 1


def _reference_ab_variants():
    """The names ab_study.py's variant_cfg accepts."""
    tree = ast.parse(open(os.path.join(TOOLS, "ab_study.py")).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "variant_cfg")
    return {n.comparators[0].value for n in ast.walk(fn) if isinstance(n, ast.Compare)}


def test_ab_study_variants_match_reference():
    """Each variant's switches as ab_study.py:65-86 sets them, and one
    variant's full run with the reference's row."""
    tool = _load("torch_ab_study")
    assert set(tool.VARIANTS) == _reference_ab_variants()
    base = _config()
    want = {"baseline": (True, True, True), "deskew": (True, True, True),
            "no_deskew": (False, True, True), "no_loops": (True, False, True),
            "no_priors": (True, True, False), "no_loops_no_priors": (True, False, False)}
    for name, (deskew, loops, priors) in want.items():
        cfg, with_priors = tool.variant_config(base, name)
        assert (cfg.sensor.deskew_enabled, cfg.loop.enable, with_priors) == (deskew, loops,
                                                                             priors), name
    with pytest.raises(ValueError):
        tool.variant_config(base, "no_such_variant")
    sim = SimConfig(**small_sim_kwargs(N_FRAMES))
    row = tool.run_variant(*tool.variant_config(base, "no_loops_no_priors"), sim, "cpu")
    assert set(SequenceResult().to_json()) | {"variant_wall_s", "ate_frontend_rmse_m"} <= set(row)
    assert row["n_scans"] == N_FRAMES and row["n_prior_factors"] == 0


def test_ab_defaults_label_follows_the_config():
    """The default row's label from the config's values (the reference's
    reads "rebind=5" where its config ships 10), and every other row of
    ab_defaults.py:51-62, each one knob of the mapping config changed."""
    tool = _load("torch_ab_defaults")
    from rolo_tpu_torch.config import RoloConfig

    base = RoloConfig()
    rows = tool.variants(base)
    labels = list(rows)
    assert labels[0] == "default (approx=T rebind=10 cand=0 iters=16)"
    assert rows[labels[0]] is base
    ref_labels, _ = _report_keys("ab_defaults", "variants")
    assert set(labels[1:]) == {k for k in ref_labels if not k.startswith("default")}
    for label in labels[1:]:
        changed = [f.name for f in dataclasses.fields(base.mapping)
                   if getattr(rows[label].mapping, f.name) != getattr(base.mapping, f.name)]
        assert len(changed) <= 1, (label, changed)
        assert rows[label].static == base.static and rows[label].loop == base.loop
    five = base.replace(mapping=dataclasses.replace(base.mapping, scan2map_rebind_every=5))
    assert list(tool.variants(five))[0] == "default (approx=T rebind=5 cand=0 iters=16)"


@pytest.mark.parametrize("name", PORT_TOOLS)
def test_tool_refuses_to_run_without_a_card(name, monkeypatch):
    """No CUDA device here: each tool's main exits non-zero before it
    measures anything, and falls back to nothing."""
    tool = _load(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    with pytest.raises(SystemExit) as exc:
        tool.main()
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)

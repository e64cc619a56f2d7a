"""The port's scaling tools (tools/torch_bench_scaling.py,
tools/torch_bench_weak_2proc.py) and their launcher
(rolo_tpu_torch/parallel/launch.py) on the CPU over gloo, at 256 points and
4 pairs: their inputs are the reference tools' own construction (read from
their source with ast and run here), their rows carry the reference rows'
keys (SCALING.json, read only) plus the port's, the pod slice runs, a
batch split over two ranks gathers to the one-process batch's bits and to
the JAX reference's poses, and a rank that fails or hangs makes the tool
raise. Every group is spawned processes on a TCP store, as on the card."""

import ast
import functools
import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import REPO, rot_err_deg

from __graft_entry__ import _synthetic_features
from rolo_tpu.config import RegistrationConfig as JRegistrationConfig
from rolo_tpu.parallel.batch import registration_batch as jregistration_batch
from rolo_tpu_torch.parallel import launch

TOOLS = os.path.join(REPO, "tools")
N, B = 256, 4
VOXEL_CAPACITY = 512
# tests/test_torch_registration.py's front-end tolerance: the packages'
# covariances differ slightly by design, and an f32 LM exit by one iteration
POSE_ROT_DEG = 0.05
POSE_TRANS_M = 0.005
ADDED = {"torch_bench_scaling": {"n_physical_cores", "cards", "ranks_exceed_cards", "backend"},
         "torch_bench_weak_2proc": {"cards", "ranks_per_card", "backend"}}


@functools.lru_cache(maxsize=None)
def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", os.path.join(TOOLS,
                                                                                f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def _reference_inputs(name, b):
    """(src, tgt, masks) from the reference tool's own statements: main()'s
    in tools/bench_scaling.py, the worker source's in tools/bench_weak_2proc.py."""
    tree = ast.parse(open(os.path.join(TOOLS, f"{name}.py")).read())
    if name == "bench_weak_2proc":
        worker = next(node.value.value for node in tree.body if isinstance(node, ast.Assign)
                      and node.targets[0].id == "_WORKER")
        body = ast.parse(worker).body
    else:
        body = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
                    and node.name == "main").body
    wanted = [node for node in body if isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id in ("rng", "src", "ang", "tgt", "masks")]
    assert [node.targets[0].id for node in wanted if node.targets[0].id != "rng"] == \
        ["src", "ang", "tgt", "masks"]
    scope = {"np": np, "_synthetic_features": _synthetic_features, "b": b, "n": N}
    exec(compile(ast.Module(body=wanted, type_ignores=[]), name, "exec"), scope)
    return scope["src"], scope["tgt"], scope["masks"]


@pytest.mark.parametrize("name,b", [("bench_scaling", B), ("bench_weak_2proc", 2 * 2)])
def test_inputs_are_the_reference_construction(name, b):
    got = launch.inputs(N, b)
    for a, w in zip(got, _reference_inputs(name, b)):
        assert a.dtype == w.dtype and np.array_equal(a, w)


@pytest.fixture(scope="module")
def rows():
    """Both tools at the tiny size: the scaling tool's groups of 1 and 2
    ranks, the weak tool's one process and two."""
    scaling = _load("torch_bench_scaling")
    strong, pod = scaling.measure(N, B, VOXEL_CAPACITY, repeats=1, ranks=2, device="cpu")
    weak = _load("torch_bench_weak_2proc").measure(N, 2, "cpu", repeats=1)
    return {"torch_bench_scaling": (strong, pod), "torch_bench_weak_2proc": weak}


def _scaling_json():
    with open(os.path.join(REPO, "SCALING.json")) as f:
        return json.load(f)


def test_scaling_rows_carry_the_reference_keys(rows):
    strong, pod = rows["torch_bench_scaling"]
    want = set(_scaling_json()["strong_virtual_devices"]["rows"][0])
    assert pod is None  # a pod row needs --ranks >= 8
    assert [r["devices"] for r in strong] == [1, 2]
    for r in strong:
        assert set(r) == want | ADDED["torch_bench_scaling"]
        assert r["total_batch"] == B and r["backend"] == "gloo" and r["cards"] == 0
        assert np.isfinite(r["time_s"]) and r["time_s"] > 0
        np.testing.assert_allclose(r["regs_per_s"], B / r["time_s"], rtol=0.01)
    assert strong[0]["speedup_vs_1dev"] == 1.0 and strong[0]["parallel_efficiency"] == 1.0


def test_weak_row_carries_the_reference_keys(rows):
    row = rows["torch_bench_weak_2proc"]
    assert set(row) == set(_scaling_json()["weak_2process"]) | ADDED["torch_bench_weak_2proc"]
    assert row["per_device_batch"] == 2 and row["points"] == N
    assert row["backend"] == "gloo" and row["ranks_per_card"] == 2
    np.testing.assert_allclose(row["weak_efficiency"], row["t_1proc_s"] / row["t_2proc_s"],
                               rtol=0.01)


def test_pod_mesh_slices_the_batch():
    """The pod row's path on a 2 x 1 ("host", "batch") mesh: each rank
    registers its host-major slice."""
    res = launch.time_group(2, N, B, VOXEL_CAPACITY, 1, "cpu", 0, pod=True)
    assert res["batch"] == B // 2 and res["backend"] == "gloo" and res["time_s"] > 0


_GATHER_WORKER = r"""
import sys
port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from rolo_tpu_torch.config import RegistrationConfig
from rolo_tpu_torch.parallel import launch, make_mesh, registration_batch
from rolo_tpu_torch.parallel.mesh import distributed_init
from rolo_tpu_torch.parallel.spmd import _all_gather

N, B, CAP = {n}, {b}, {cap}
assert distributed_init(f"localhost:{{port}}", 2, rank, backend="gloo")
mesh = make_mesh(device_type="cpu")
cfg = RegistrationConfig()
mine = registration_batch(*launch.rank_inputs(mesh, N, B, "cpu"), cfg=cfg, voxel_capacity=CAP,
                          k=launch.K)
gathered = [_all_gather(field, None) for field in mine]
if rank == 0:
    src, tgt, masks = (torch.tensor(x) for x in launch.inputs(N, B))
    z, dt = torch.zeros(B, 3), torch.full((B,), 0.1)
    whole = registration_batch(src, masks, tgt, masks, z, z, dt, dt, cfg=cfg, voxel_capacity=CAP,
                               k=launch.K)
    for name, a, w in zip(whole._fields, gathered, whole):
        assert torch.equal(a, w), name
    np.savez(out, **{{name: g.numpy() for name, g in zip(whole._fields, gathered)}})
torch.distributed.destroy_process_group()
print(f"WORKER_{{rank}}_OK")
"""


def test_split_batch_gathers_to_the_one_process_bits_and_the_reference(tmp_path):
    """Two ranks each register their 2 of the 4 pairs; gathered, they are
    torch.equal to one process's batch of 4 (checked in rank 0, both at one
    thread), and within the front-end tolerance of the JAX reference's
    registration_batch on the same inputs."""
    script = tmp_path / "gather_worker.py"
    script.write_text(_GATHER_WORKER.format(n=N, b=B, cap=VOXEL_CAPACITY))
    out = tmp_path / "gathered.npz"
    logs = launch.run_ranks(lambda r, port: [sys.executable, str(script), str(port), str(r),
                                             str(out)], 2, timeout=240)
    assert all(f"WORKER_{r}_OK" in log for r, log in enumerate(logs)), logs
    got = np.load(out)
    src, tgt, masks = launch.inputs(N, B)
    z, dt = jnp.zeros((B, 3)), jnp.full((B,), 0.1, jnp.float32)
    want = jregistration_batch(jnp.asarray(src), jnp.asarray(masks), jnp.asarray(tgt),
                               jnp.asarray(masks), z, z, dt, dt, JRegistrationConfig(),
                               VOXEL_CAPACITY, launch.K)
    assert (rot_err_deg(got["rot"], np.asarray(want.rot)) < POSE_ROT_DEG).all()
    assert (np.linalg.norm(got["trans"] - np.asarray(want.trans), axis=1) < POSE_TRANS_M).all()


@pytest.mark.parametrize("name", ["torch_bench_scaling", "torch_bench_weak_2proc"])
def test_a_failing_rank_makes_the_tool_raise(name):
    """A rank that cannot take its device exits non-zero: the tool raises
    with that rank's output, and leaves no process behind."""
    tool = _load(name)
    with pytest.raises(RuntimeError, match=r"rank 0 of 1 exited 1:[\s\S]*nodevice"):
        if name == "torch_bench_scaling":
            tool.measure(N, B, VOXEL_CAPACITY, repeats=1, ranks=1, device="nodevice")
        else:
            tool.measure(N, 2, "nodevice", repeats=1)


def test_a_hanging_group_makes_the_launcher_raise():
    """A group that outlives its timeout (a rank left waiting in a
    collective) is stopped, and the launcher raises."""
    with pytest.raises(RuntimeError, match="outlived 1 s"):
        launch.run_ranks(lambda r, port: [sys.executable, "-c", "import time; time.sleep(60)"],
                         2, timeout=1)


@pytest.mark.parametrize("ranks,cards,device,want", [
    (1, 1, "cuda", "nccl"), (2, 1, "cuda", "gloo"), (2, 2, "cuda", "nccl"), (8, 4, "cuda", "gloo"),
    (2, 0, "cpu", "gloo"),
])
def test_backend_follows_the_cards(ranks, cards, device, want):
    """NCCL only where every rank has a card of its own."""
    assert launch.backend_for(ranks, cards, device) == want


@pytest.mark.parametrize("name", ["torch_bench_scaling", "torch_bench_weak_2proc"])
def test_tool_writes_a_file_only_to_out(name, tmp_path, monkeypatch, capsys):
    """main() with a card (the measurement stubbed) prints its report and
    writes nothing; with --out it writes the report there. SCALING.json is
    never touched."""
    from rolo_tpu_torch.runtime import platform

    tool = _load(name)
    row = {"devices": 1, "time_s": 0.5}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(platform, "bench_metadata", lambda: {"device": "stub"})
    monkeypatch.setattr(tool, "measure", lambda *a, **k: ([row], None)
                        if name == "torch_bench_scaling" else dict(row))
    before = os.stat(os.path.join(REPO, "SCALING.json")).st_mtime_ns
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    assert tool.main() == 0
    assert os.listdir(tmp_path) == []
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["machine"] == {"device": "stub"}
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--out", "report.json"])
    assert tool.main() == 0
    with open(tmp_path / "report.json") as f:
        assert json.load(f) == report
    assert os.stat(os.path.join(REPO, "SCALING.json")).st_mtime_ns == before

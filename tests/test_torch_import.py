"""The port runs where JAX and PyYAML do not exist: importing every module of
it, its own config and chip_smoke.py, and running CPU scan_steps,
backend_steps, a loop-closure pass, a prior cycle, ESKF fusion, a graph solve,
three SlamSystem scans with a checkpoint and a restore, a batched mapping
step, and the one-rank dry run of graft_entry (batched and point-split
registration, batched mapping), and loading the port's tools (the measuring
tools, the stage profilers and the diagnostics), must never import jax or yaml
nor execute a file of the JAX package. Its config copy reads the same values
as the reference's, its state constructors default to the card, and every
subpackage exports the names its reference counterpart does."""

import ast
import importlib
import os
import subprocess
import sys

import pytest
import torch

import torch_parity  # caps torch threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["yaml"] = None  # the card's machine has no PyYAML either
import torch
torch.set_num_threads(2)
import rolo_tpu_torch
from rolo_tpu_torch.config import RoloConfig, RegistrationConfig, StaticConfig, load_config
import chip_smoke  # module only; main() is not run
from rolo_tpu_torch.frontend.odometry import init_state, scan_step
import rolo_tpu_torch.bench
import rolo_tpu_torch.graph.factors, rolo_tpu_torch.graph.solver
import rolo_tpu_torch.loop.scancontext, rolo_tpu_torch.prior.association
import rolo_tpu_torch.mapping.backend, rolo_tpu_torch.mapping.keyframes
import rolo_tpu_torch.mapping.scan2map
import rolo_tpu_torch.ops.eig3, rolo_tpu_torch.ops.rows, rolo_tpu_torch.ops.pytree
import rolo_tpu_torch.loop.closure, rolo_tpu_torch.pointcloud.ground_seg
import rolo_tpu_torch.prior.ground, rolo_tpu_torch.prior.vehicle
import rolo_tpu_torch.filter.eskf, rolo_tpu_torch.filter.fusion
import rolo_tpu_torch.runtime.cycles, rolo_tpu_torch.sim.dataset
import rolo_tpu_torch.runtime.slam, rolo_tpu_torch.runtime.dataset, rolo_tpu_torch.runtime.io
import rolo_tpu_torch.runtime.metrics, rolo_tpu_torch.runtime.profiling
import rolo_tpu_torch.runtime.bagwriter, rolo_tpu_torch.runtime.viz
import rolo_tpu_torch.cpp.host, rolo_tpu_torch.__main__
import rolo_tpu_torch.filter.manifold, rolo_tpu_torch.registration.experimental
import rolo_tpu_torch.parallel, rolo_tpu_torch.parallel.launch, rolo_tpu_torch.graft_entry
# the subpackages' public surface, as the JAX package's README imports it
from rolo_tpu_torch.mapping import backend_step, solve_graph_host
import rolo_tpu_torch.frontend, rolo_tpu_torch.geometry, rolo_tpu_torch.graph
import rolo_tpu_torch.loop, rolo_tpu_torch.mapping, rolo_tpu_torch.ops
import rolo_tpu_torch.pointcloud, rolo_tpu_torch.prior, rolo_tpu_torch.sim, rolo_tpu_torch.voxel
import importlib.util
for tool in ("torch_bench_batch_mapping", "torch_bench_latency", "torch_bench_pipeline",
             "torch_ab_study", "torch_ab_defaults", "torch_profile_frontend",
             "torch_profile_stages", "torch_profile_build", "torch_profile_backend",
             "torch_profile_projection", "torch_diag_dense_solve", "torch_diag_graphsolve",
             "torch_diag_ct", "torch_diag_prior", "torch_bench_scaling",
             "torch_bench_weak_2proc"):
    spec = importlib.util.spec_from_file_location(tool, f"tools/{tool}.py")
    module = sys.modules[tool] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # module only; main() not run

g = torch.Generator().manual_seed(0)
n = 256
xyz = torch.rand(n, 3, generator=g) * 20.0 - 10.0
xyz[:, 2] = torch.where(torch.arange(n) % 2 == 0, -1.5, xyz[:, 2])
mask = torch.ones(n, dtype=torch.bool)
state = init_state(n, "cpu")
state, out = scan_step(state, xyz, mask, 0.1, RegistrationConfig(), 512, 10)
state, out = scan_step(state, xyz, mask, 0.1, RegistrationConfig(), 512, 10)
assert torch.isfinite(out.pose_trans).all() and torch.isfinite(out.pose_rot).all()

from rolo_tpu_torch.config import load_config
from rolo_tpu_torch.mapping.backend import backend_step, init_backend, solve_graph_host
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
cfg = load_config("tests/fixtures/sim_bag/config.yaml")
bstate = init_backend(cfg, "cpu")
for step in range(2):
    cloud = PaddedCloud(torch.cat([xyz, torch.zeros(cfg.static.max_surf_points - n, 3)]),
                        torch.arange(cfg.static.max_surf_points) < n)
    bstate, bout = backend_step(bstate, cloud, cloud, cloud, out.pose_rot, out.pose_trans, True,
                                0.2 * step, cfg)
from rolo_tpu_torch.filter.fusion import init_fusion, on_front_odometry, on_mapping_odometry
from rolo_tpu_torch.mapping.backend import loop_closure_step
from rolo_tpu_torch.prior.ground import GroundMap
from rolo_tpu_torch.prior.vehicle import from_config
from rolo_tpu_torch.runtime.cycles import prior_cycle
bstate, _ = loop_closure_step(bstate, cfg)
fus = init_fusion(cfg.filter, "cpu")
for step in range(3):
    fus, _ = on_front_odometry(fus, 0.1 * step, out.pose_rot, out.pose_trans, cfg.filter)
fus = on_mapping_odometry(fus, bout.rot, bout.trans, out.pose_rot, out.pose_trans)
ground = GroundMap(xyz.repeat(16, 1), torch.ones(16 * n, dtype=torch.bool))  # >= the patch
bstate, _ = prior_cycle(fus, 0.2, bstate, ground, from_config(cfg.prior, "cpu"), cfg)
bstate = solve_graph_host(bstate, cfg)
assert int(bstate.db.count) >= 1 and torch.isfinite(bstate.xyz).all()
assert RoloConfig().static.max_feature_points == 8192

# the runtime: three scans through SlamSystem, a checkpoint and a restore
import os, tempfile
import numpy as np
from rolo_tpu_torch.runtime.slam import SlamSystem
from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence
slam = SlamSystem(cfg, device="cpu")
for frame in generate_sequence(SimConfig(n_scans=3, n_cols=512, sensor="velodyne16"), "cpu"):
    slam.process_scan(frame.points, frame.stamp, ring=frame.ring, rel_time=frame.rel_time)
with tempfile.TemporaryDirectory() as tmp:
    slam.checkpoint(os.path.join(tmp, "ckpt.npz"))
    again = SlamSystem(cfg, device="cpu")
    again.restore(os.path.join(tmp, "ckpt.npz"))
assert torch.equal(again.odom_state.pose_trans, slam.odom_state.pose_trans)
assert int(again.backend_state.db.count) == int(slam.backend_state.db.count) >= 1
assert len(slam.times) == 3 and np.isfinite(slam.front_positions_np()).all()

# the seventh slice: a batch of two back-end states, one mapping step
from rolo_tpu_torch.ops.pytree import tree_index
pair = init_backend(cfg, "cpu", batch=2)
cloud2 = PaddedCloud(cloud.xyz.expand(2, -1, -1), cloud.mask.expand(2, -1))
pair, pout = backend_step(pair, cloud2, cloud2, cloud2, out.pose_rot.expand(2, 3, 3),
                          out.pose_trans.expand(2, 3), True, 0.0, cfg)
pair = solve_graph_host(pair, cfg)
assert pair.db.count.tolist() == [1, 1] and torch.equal(tree_index(pair, 0).xyz, pair.xyz[1])

# the sixth slice: the dry run over a one-rank group (all three phases)
from rolo_tpu_torch.graft_entry import dryrun_multichip
dryrun_multichip(1, device="cpu")
assert not any(m == "jax" or m.startswith(("jax.", "rolo_tpu.")) or m == "rolo_tpu"
               for m in sys.modules if sys.modules[m] is not None)
# by file, too: a module of the JAX package loaded under another name
import os
ref = os.path.join(os.path.abspath("rolo_tpu"), "")
loaded = [getattr(m, "__file__", None) for m in list(sys.modules.values()) if m is not None]
assert not [f for f in loaded if f and os.path.abspath(f).startswith(ref)], loaded
print("JAX-FREE-OK")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAX-FREE-OK" in proc.stdout


def test_config_shim_matches_reference_defaults():
    import dataclasses

    from rolo_tpu.config import RoloConfig as JRoloConfig

    from rolo_tpu_torch.config import RoloConfig, load_config

    assert dataclasses.asdict(RoloConfig()) == dataclasses.asdict(JRoloConfig())
    cfg = load_config(torch_parity.FIXTURE_CONFIG)
    assert cfg.static.max_feature_points == 1536 and cfg.sensor.n_scan == 16


CONFIG_FILES = [
    (torch_parity.FIXTURE_CONFIG,),
    (os.path.join(REPO, "configs", "rellis", "params.yaml"),
     os.path.join(REPO, "configs", "rellis", "prior_pose_params.yaml")),
]


@pytest.mark.parametrize("paths", CONFIG_FILES, ids=["sim_bag", "rellis"])
def test_config_copy_loads_yaml_like_reference(paths):
    """The port's own copy of the config module reads the same YAML into the
    same values, field for field, as the JAX package's."""
    import dataclasses

    from rolo_tpu.config import load_config as jload_config

    from rolo_tpu_torch import config as pc

    got, want = pc.load_config(list(paths)), jload_config(list(paths))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got.registration) is pc.RegistrationConfig
    assert got != pc.RoloConfig()  # the files do change fields


def test_config_copy_executes_no_reference_file():
    from rolo_tpu_torch import config as pc

    src = open(pc.__file__).read()
    assert "spec_from_file_location" not in src
    assert os.path.dirname(os.path.abspath(pc.__file__)).endswith("rolo_tpu_torch")


def test_state_constructors_default_to_the_card():
    """With no device, the state constructors allocate on CUDA: on a machine
    without a card that raises instead of quietly building CPU state."""
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.filter.fusion import init_fusion
    from rolo_tpu_torch.mapping.backend import init_backend
    from rolo_tpu_torch.runtime.platform import default_device

    assert default_device() == torch.device("cuda")
    cfg = torch_parity.small_config()
    if torch.cuda.is_available():
        assert init_backend(cfg).db.rot.device.type == "cuda"
        assert init_fusion(cfg.filter).front_rot.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        init_backend(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        init_fusion(RoloConfig().filter)


def _reference_exports():
    """(subpackage, its __all__) for every subpackage of the JAX package, read
    with ast: nothing of the JAX package is imported."""
    root = os.path.join(REPO, "rolo_tpu")
    out = []
    for sub in sorted(os.listdir(root)):
        init = os.path.join(root, sub, "__init__.py")
        if not os.path.exists(init):
            continue
        tree = ast.parse(open(init).read())
        names = [ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and any(getattr(t, "id", None) == "__all__" for t in node.targets)]
        out.append((sub, names[0] if names else []))
    return out


@pytest.mark.parametrize("sub,names", _reference_exports(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_subpackage_exports_the_reference_names(sub, names):
    """`from rolo_tpu_torch.<sub> import <name>` works for every name of the
    reference subpackage's __all__, and each resolves to the port's own
    object."""
    assert names, f"rolo_tpu/{sub}/__init__.py has no __all__"
    mod = importlib.import_module(f"rolo_tpu_torch.{sub}")
    assert sorted(mod.__all__) == sorted(names)
    for name in names:
        obj = getattr(mod, name)
        origin = getattr(obj, "__module__", None) or getattr(obj, "__name__", None)
        if origin is not None:
            assert origin.startswith("rolo_tpu_torch."), (name, origin)

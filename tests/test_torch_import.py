"""The port runs where JAX does not exist: importing it, its config shim and
chip_smoke.py, and running one CPU scan_step, must never import jax."""

import os
import subprocess
import sys

import torch_parity  # noqa: F401  (caps torch threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
torch.set_num_threads(2)
import rolo_tpu_torch
from rolo_tpu_torch.config import RoloConfig, RegistrationConfig, StaticConfig, load_config
import chip_smoke  # module only; main() is not run
from rolo_tpu_torch.frontend.odometry import init_state, scan_step

g = torch.Generator().manual_seed(0)
n = 256
xyz = torch.rand(n, 3, generator=g) * 20.0 - 10.0
xyz[:, 2] = torch.where(torch.arange(n) % 2 == 0, -1.5, xyz[:, 2])
mask = torch.ones(n, dtype=torch.bool)
state = init_state(n, "cpu")
state, out = scan_step(state, xyz, mask, 0.1, RegistrationConfig(), 512, 10)
state, out = scan_step(state, xyz, mask, 0.1, RegistrationConfig(), 512, 10)
assert torch.isfinite(out.pose_trans).all() and torch.isfinite(out.pose_rot).all()
assert RoloConfig().static.max_feature_points == 8192
assert not any(m == "jax" or m.startswith(("jax.", "rolo_tpu.")) or m == "rolo_tpu"
               for m in sys.modules if sys.modules[m] is not None)
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

"""The check that a run loaded neither JAX nor the JAX package compares
whole top-level names: it refuses jax, jaxlib, flax and rolo_tpu, and admits
rolo_tpu_torch, whose name begins with the JAX package's."""

from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.harness import guard, spec


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                  "rolo_tpu", "rolo_tpu.config"])
def test_refuses(name):
    assert guard.forbidden_modules([name, "numpy"]) == [name]


@pytest.mark.parametrize("name", ["rolo_tpu_torch", "rolo_tpu_torch.config", "jaxtyping",
                                  "benchmark.harness.guard", "numpy"])
def test_admits(name):
    assert guard.forbidden_modules([name]) == []


def test_a_run_loads_no_jax():
    """Importing everything a run imports, the program included, leaves
    nothing forbidden in sys.modules (in a fresh process)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.harness.drivers as d, benchmark.harness.variants\n"
            "from benchmark.harness import capture, guard\n"
            "capture.install_taps()\n"
            "import rolo_tpu_torch.runtime.slam, rolo_tpu_torch.mapping.backend\n"
            "print(guard.loaded_forbidden())\n" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

"""Device setup and provenance for the port's entry points.

Counterpart of `rolo_tpu/runtime/platform.py`. The JAX package raises its
matmul precision at import because a short mantissa at lidar range scrambles
k-NN membership and biases every Hessian (the round-4 regression). The port
does the same once, at each entry point: full f32 matmuls, no TF32 anywhere.
"""

from __future__ import annotations

import os
import platform as _plat
import subprocess

import torch


def configure_precision() -> None:
    """Full-f32 matmuls and convolutions (TF32 keeps ~3 decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def nvidia_smi_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, or
    "not available" where the tool is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError):
        return "not available"
    line = out.stdout.strip().splitlines()
    return line[0].strip() if out.returncode == 0 and line else "not available"


def _git_sha():
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True,
            timeout=5,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return sha or None


def bench_metadata() -> dict:
    """Machine stamp for every bench JSON, from torch and nvidia-smi."""
    cuda = torch.cuda.is_available()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "nvidia_smi": nvidia_smi_name_power() if cuda else "not available",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "host": _plat.node() or "unknown",
        "git_sha": _git_sha(),
    }

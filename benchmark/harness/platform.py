"""The card's settings and provenance.

`nvidia_smi_name_power` is a copy of the one in
`rolo_tpu_torch/runtime/platform.py`, as of commit fba7730.
"""

from __future__ import annotations

import subprocess

import torch


def full_f32() -> None:
    """Full-f32 matrix products, TF32 off: the precision the program states
    and the reference computes in."""
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

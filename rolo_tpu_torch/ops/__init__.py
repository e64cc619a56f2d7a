"""SoA sym3 algebra, small solves, and the two CUDA kernels
(counterpart of rolo_tpu/ops)."""

from .linalg import inv3x3, solve_psd

__all__ = ["inv3x3", "solve_psd"]

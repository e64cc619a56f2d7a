"""SO(3) and SE(3) maps (counterpart of rolo_tpu/geometry)."""

from . import so3, se3
from .se3 import SE3

__all__ = ["so3", "se3", "SE3"]

"""Plain reference of the program's front-end step, `scan_step`: rot-GICP
of the previous scan's features onto this scan's.

The modules under this package are frozen copies of the program's, as of
commit fba7730 (each says which); the two CUDA kernels are computed by the
plain versions of `benchmark/reference/kernels.py`. Nothing of the program
is imported. The benchmark hands the step the inputs that the program's
step was given, recomputes it in float64 and compares the step: it is
followed from the program's own state (the previous scan's features and
last step), which the features check and the pose checks against the
truth cover apart.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch


@contextlib.contextmanager
def default_dtype(dtype: torch.dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def cast(value, dtype: torch.dtype):
    """Floating tensors in `value` (nested tuples, lists) as `dtype`."""
    if isinstance(value, torch.Tensor):
        return value.to(dtype) if value.is_floating_point() else value
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(cast(v, dtype) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(cast(v, dtype) for v in value)
    return value


def registration_config(pinned: Dict):
    """The copy's registration parameters from a configuration's pin."""
    from .config import RegistrationConfig

    fields = dict(pinned)
    fields["polar_resolution"] = tuple(fields["polar_resolution"])
    return RegistrationConfig(**fields)


def frontend_step(state, new_xyz, new_mask, interval, reg, voxel_capacity: int, k: int,
                  enable_failure_gate: bool, dtype: torch.dtype = torch.float64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step (rot [..., 3, 3], trans [..., 3]) of one `scan_step` from the
    given state (the fields of the program's OdometryState, in order). The
    previous scan's covariances are recomputed from its points."""
    from .frontend import odometry
    from .voxel.knn import estimate_cov6

    with default_dtype(dtype):
        st = odometry.OdometryState(*cast(tuple(state), dtype))
        batched = st.prev_xyz.dim() == 3
        xyz, mask = (st.prev_xyz, st.prev_mask) if batched else (st.prev_xyz[None],
                                                                 st.prev_mask[None])
        cov = estimate_cov6(xyz, mask, k=k, method=reg.regularization)
        st = st._replace(prev_cov=cov if batched else cov[0])
        _, out = odometry.scan_step(st, cast(new_xyz, dtype), new_mask, cast(interval, dtype),
                                    reg, voxel_capacity, k,
                                    enable_failure_gate=enable_failure_gate)
    return out.step_rot, out.step_trans

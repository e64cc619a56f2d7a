"""Ground-prior stack: ground map, vehicle contact solver, prior queue and
association (counterpart of rolo_tpu/prior)."""

from .association import (
    PriorFactor,
    PriorObservation,
    PriorQueue,
    associate_prior,
    compute_prior,
    init_queue,
    push_prior,
)
from .ground import (
    GroundMap,
    average_height_at,
    contact_point,
    extract_patch,
    fit_local_surface,
    from_cloud,
    nearest_point_xy,
)
from .vehicle import SolverResult, VehicleModel, from_config, solve_pose

__all__ = [
    "PriorFactor",
    "PriorObservation",
    "PriorQueue",
    "associate_prior",
    "compute_prior",
    "init_queue",
    "push_prior",
    "GroundMap",
    "average_height_at",
    "contact_point",
    "extract_patch",
    "fit_local_surface",
    "from_cloud",
    "nearest_point_xy",
    "SolverResult",
    "VehicleModel",
    "from_config",
    "solve_pose",
]

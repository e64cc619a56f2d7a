"""Pose-graph factors and the batched Gauss-Newton solver (counterpart of
rolo_tpu/graph)."""

from .factors import (
    BetweenFactors,
    PoseGraph,
    empty_between,
    empty_graph,
    add_between,
    FIRST_PRIOR_VARIANCES,
    ODOM_VARIANCES,
)
from .solver import GraphSolution, marginal_covariance, solve_pose_graph

__all__ = [
    "BetweenFactors",
    "PoseGraph",
    "empty_between",
    "empty_graph",
    "add_between",
    "FIRST_PRIOR_VARIANCES",
    "ODOM_VARIANCES",
    "GraphSolution",
    "marginal_covariance",
    "solve_pose_graph",
]

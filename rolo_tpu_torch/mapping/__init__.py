"""Keyframe store, scan-to-submap alignment and the back-end step
(counterpart of rolo_tpu/mapping)."""

from .keyframes import (
    KeyframeDB,
    init_db,
    add_keyframe,
    should_add_keyframe,
    update_poses,
    extract_submap,
)
from .backend import (
    BackendOutput,
    BackendState,
    backend_step,
    init_backend,
    loop_closure_step,
    prior_step,
    record_prior_observation,
    solve_graph_host,
)
from .scan2map import (
    FactorSet,
    Scan2MapResult,
    corner_factors,
    surf_factors,
    scan2map_optimize,
    constrain_transform,
)

__all__ = [
    "BackendOutput",
    "BackendState",
    "backend_step",
    "init_backend",
    "loop_closure_step",
    "prior_step",
    "record_prior_observation",
    "solve_graph_host",
    "KeyframeDB",
    "init_db",
    "add_keyframe",
    "should_add_keyframe",
    "update_poses",
    "extract_submap",
    "FactorSet",
    "Scan2MapResult",
    "corner_factors",
    "surf_factors",
    "scan2map_optimize",
    "constrain_transform",
]

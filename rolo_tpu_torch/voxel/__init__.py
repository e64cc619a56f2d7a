"""Per-point covariances and voxel maps (counterpart of rolo_tpu/voxel)."""

from .voxelmap import (
    VoxelMap,
    build_voxel_map,
    lookup,
    lookup_join,
    polar_coord,
    polar_origin,
    uniform_coord,
)
from .knn import knn_indices, estimate_covariances, estimate_cov6, regularize_covariance

__all__ = [
    "VoxelMap",
    "build_voxel_map",
    "lookup",
    "lookup_join",
    "polar_coord",
    "polar_origin",
    "uniform_coord",
    "knn_indices",
    "estimate_covariances",
    "estimate_cov6",
    "regularize_covariance",
]

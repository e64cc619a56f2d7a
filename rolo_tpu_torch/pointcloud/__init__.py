"""Padded clouds, range-image projection, LOAM features and ground
segmentation (counterpart of rolo_tpu/pointcloud)."""

from .cloud import PaddedCloud, concat_clouds, compact_cloud
from .projection import RawScan, RingImage, project_scan
from .features import FeatureClouds, extract_features, voxel_downsample

__all__ = [
    "PaddedCloud",
    "concat_clouds",
    "compact_cloud",
    "RawScan",
    "RingImage",
    "project_scan",
    "FeatureClouds",
    "extract_features",
    "voxel_downsample",
]

"""Raycast LiDAR simulator (counterpart of rolo_tpu/sim): the data source
on a machine without JAX."""

from .scene import Scene, default_scene, loop_trajectory_pose
from .lidar import LidarModel, simulate_scan
from .dataset import SimConfig, generate_sequence, ground_map_points

__all__ = [
    "Scene",
    "default_scene",
    "loop_trajectory_pose",
    "LidarModel",
    "simulate_scan",
    "SimConfig",
    "generate_sequence",
    "ground_map_points",
]

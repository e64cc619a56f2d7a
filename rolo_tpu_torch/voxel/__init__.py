"""Per-point covariances and voxel maps (counterpart of rolo_tpu/voxel)."""

"""Frozen copies of `rolo_tpu_torch/voxel/` (see `benchmark/reference/steps`)."""

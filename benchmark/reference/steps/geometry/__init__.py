"""Frozen copies of `rolo_tpu_torch/geometry/` (see `benchmark/reference/steps`)."""

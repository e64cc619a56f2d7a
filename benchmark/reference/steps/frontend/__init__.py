"""Frozen copies of `rolo_tpu_torch/frontend/` (see `benchmark/reference/steps`)."""

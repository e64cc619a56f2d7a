"""Frozen copies of `rolo_tpu_torch/ops/` (see `benchmark/reference/steps`)."""

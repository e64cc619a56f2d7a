"""Frozen copies of `rolo_tpu_torch/registration/` (see `benchmark/reference/steps`)."""

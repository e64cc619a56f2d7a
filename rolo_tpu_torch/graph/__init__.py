"""Pose-graph factors and the batched Gauss-Newton solver (counterpart of
rolo_tpu/graph)."""

"""SO(3) and SE(3) maps (counterpart of rolo_tpu/geometry)."""

"""Padded clouds, range-image projection and LOAM features (counterpart
of rolo_tpu/pointcloud)."""

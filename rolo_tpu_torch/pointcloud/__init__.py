"""Padded clouds, range-image projection, LOAM features and ground
segmentation (counterpart of rolo_tpu/pointcloud)."""

"""Raycast LiDAR simulator (counterpart of rolo_tpu/sim): the data source
on a machine without JAX."""

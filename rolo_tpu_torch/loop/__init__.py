"""Scan Context descriptors (counterpart of rolo_tpu/loop; detection and
ICP verification belong to the loop-closure slice)."""

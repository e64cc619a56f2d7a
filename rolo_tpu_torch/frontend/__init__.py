"""Scan-to-scan odometry (counterpart of rolo_tpu/frontend)."""

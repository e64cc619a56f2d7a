"""Scan-to-scan odometry (counterpart of rolo_tpu/frontend)."""

from .odometry import OdometryState, OdometryOutput, init_state, scan_step, run_sequence

__all__ = ["OdometryState", "OdometryOutput", "init_state", "scan_step", "run_sequence"]

"""Keyframe store, scan-to-submap alignment and the back-end step
(counterpart of rolo_tpu/mapping)."""

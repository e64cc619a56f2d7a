"""Runtime: host IO, metrics, timers and `SlamSystem` (the counterpart of
`rolo_tpu/runtime`), plus the device setup (`platform`) and the two
back-end cycles (`cycles`) that `SlamSystem` runs.

The names of `runtime.slam` load on first access: the state constructors import
`runtime.platform`, so importing `runtime.slam` here would be circular.
"""

from .io import (load_checkpoint, read_kitti_bin, read_pcd, read_tum, save_checkpoint, write_g2o,
                 write_pcd, write_tum)
from .metrics import ATEResult, associate_by_time, ate, rpe, umeyama_alignment
from .profiling import StageTimers, device_trace

_SLAM_NAMES = ("SlamSystem", "infer_rel_time", "infer_rings")


def __getattr__(name):
    if name in _SLAM_NAMES:
        from . import slam

        return getattr(slam, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "load_checkpoint",
    "read_kitti_bin",
    "read_pcd",
    "read_tum",
    "save_checkpoint",
    "write_g2o",
    "write_pcd",
    "write_tum",
    "ATEResult",
    "associate_by_time",
    "ate",
    "rpe",
    "umeyama_alignment",
    "SlamSystem",
    "StageTimers",
    "device_trace",
    "infer_rel_time",
    "infer_rings",
]

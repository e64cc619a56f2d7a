"""State estimation (counterpart of rolo_tpu/filter): the pose ESKF, the
odometry fusion, and `manifold`, the generic IKFoM-style toolkit (declare
any vect / SO3 / S2 composition; Jacobians by autodiff through boxminus)."""

from . import manifold
from .eskf import (
    ESKFState,
    FutureRollout,
    init_filter,
    predict,
    process_measurement,
    state_predict,
    state_propagate,
    update_iterated,
)
from .fusion import (
    FusedPose,
    FusionState,
    FuturePrediction,
    fused_pose,
    init_fusion,
    on_front_odometry,
    on_mapping_odometry,
    predict_future,
)

__all__ = [
    "manifold",
    "ESKFState",
    "FutureRollout",
    "init_filter",
    "predict",
    "process_measurement",
    "state_predict",
    "state_propagate",
    "update_iterated",
    "FusedPose",
    "FusionState",
    "FuturePrediction",
    "fused_pose",
    "init_fusion",
    "on_front_odometry",
    "on_mapping_odometry",
    "predict_future",
]

"""rolo_tpu_torch: the rolo_tpu SLAM system in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package `rolo_tpu` (which stays the reference). The
subpackages mirror `rolo_tpu`'s names so each counterpart is easy to find:

  geometry/      SO(3)/SE(3) maps
  ops/           sym3 SoA algebra, small solves, eig3, pytree bridges, and
                 the two kernels: voxel_join (keyed sum) and knn_moments
  csrc/          the CUDA sources of those kernels (nvcc, sm_90a)
  voxel/         per-point covariances, voxel maps, k-NN
  registration/  rot-GICP objective and the batched LM solvers
  pointcloud/    range-image projection with deskew, LOAM features, ground
                 segmentation
  frontend/      scan-to-scan odometry
  filter/        the pose ESKF and the fused pose
  mapping/       scan-to-submap, keyframes, the back-end steps
  graph/         pose-graph factors and solver
  loop/          scan context and loop verification
  prior/         ground maps, the vehicle model, prior association
  runtime/       SlamSystem and its scheduler, the dataset harness, IO,
                 metrics, timers, exports
  cpp/           ctypes wrapper of the native bag / PCD reader
  sim/           the raycast LiDAR simulator (the card's data source)

`python -m rolo_tpu_torch run | sim | bench` is the command line. Everything
is plain PyTorch on tensors: JAX's `vmap` is an explicit leading batch dim
`B`, `jax.random` keys are `torch.Generator`s, and every entry point takes a
`device`, the card unless the caller asks for the CPU. Nothing here imports
JAX or PyYAML.
"""

from .config import RegistrationConfig, RoloConfig, StaticConfig, load_config

__version__ = "0.1.0"
__all__ = ["RoloConfig", "RegistrationConfig", "StaticConfig", "load_config", "__version__"]

"""rolo_tpu_torch: the rolo_tpu front-end in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package `rolo_tpu` (which stays the reference). The
subpackages mirror `rolo_tpu`'s names so each counterpart is easy to find:

  geometry/      SO(3)/SE(3) maps
  ops/           sym3 SoA algebra, small solves, and the two kernels:
                 voxel_join (keyed sum, CUDA) and knn_moments (CUDA)
  voxel/         per-point covariances, voxel maps
  registration/  rot-GICP objective and the batched LM solvers
  pointcloud/    range-image projection, LOAM features
  frontend/      scan-to-scan odometry
  sim/           the raycast LiDAR simulator (the card's data source)

Everything is plain PyTorch on tensors: JAX's `vmap` is an explicit leading
batch dim `B`, `jax.random` keys are `torch.Generator`s, and every entry
point takes a `device`. Nothing here imports JAX.
"""

from .config import RegistrationConfig, RoloConfig, StaticConfig, load_config

__version__ = "0.1.0"
__all__ = ["RoloConfig", "RegistrationConfig", "StaticConfig", "load_config", "__version__"]

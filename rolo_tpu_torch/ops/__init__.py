"""SoA sym3 algebra, small solves, and the two CUDA kernels
(counterpart of rolo_tpu/ops)."""

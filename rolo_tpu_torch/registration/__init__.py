"""rot-GICP objective and batched LM solvers (counterpart of
rolo_tpu/registration)."""

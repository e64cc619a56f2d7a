"""Ground-prior stack: ground map, vehicle contact solver, prior queue and
association (counterpart of rolo_tpu/prior)."""

"""Device setup and provenance (counterpart of rolo_tpu/runtime)."""

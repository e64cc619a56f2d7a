"""Ground-prior queue state (counterpart of rolo_tpu/prior; the prior stack
itself belongs to the prior slice)."""

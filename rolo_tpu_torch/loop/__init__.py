"""Scan Context place recognition and loop-closure verification (counterpart
of rolo_tpu/loop)."""

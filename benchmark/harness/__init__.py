"""The benchmark harness of rolo_tpu_torch: set-up, drivers, capture,
trace reduction and the comparison that decides `correct`. Nothing here
imports JAX or the JAX package; `guard` checks that at the end of a run."""

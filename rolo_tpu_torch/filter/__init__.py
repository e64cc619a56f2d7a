"""Pose ESKF and odometry fusion (counterpart of rolo_tpu/filter; the
generic IKFoM-style `manifold` toolkit, which no runtime path reaches, is
not ported yet)."""

"""Arithmetic the benchmark reports with, frozen here so that the program
cannot move it.

`associate_by_time` is a copy of `rolo_tpu_torch/runtime/metrics.py`'s, as
of commit fba7730.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def associate_by_time(t_a: np.ndarray, t_b: np.ndarray,
                      max_diff: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-time association (evo/TUM tooling convention).
    Returns index arrays (ia, ib)."""
    t_a = np.asarray(t_a)
    t_b = np.asarray(t_b)
    ia, ib = [], []
    j = 0
    for i, t in enumerate(t_a):
        while j + 1 < len(t_b) and abs(t_b[j + 1] - t) <= abs(t_b[j] - t):
            j += 1
        if abs(t_b[j] - t) <= max_diff:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def max_position_error(est: np.ndarray, truth: np.ndarray) -> float:
    """The largest distance between estimated and true positions [T, 3]
    (no alignment: both are in the first scan's frame); +inf when an
    estimate is not finite or there is none."""
    est = np.asarray(est, np.float64).reshape(-1, 3)
    if est.shape[0] == 0 or not np.isfinite(est).all():
        return float("inf")
    return float(np.linalg.norm(est - np.asarray(truth, np.float64), axis=1).max())

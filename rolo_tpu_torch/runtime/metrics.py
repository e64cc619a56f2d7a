"""Trajectory accuracy metrics: ATE / RPE, the port's own copy of
`rolo_tpu/runtime/metrics.py` (numpy only).

The reference exports TUM trajectories for external evaluation with evo;
this module scores runs in-repo against ground truth.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment src -> dst.
    Returns (rot [3,3], trans [3], scale)."""
    src = np.asarray(src, np.float64).T  # [3, N]
    dst = np.asarray(dst, np.float64).T
    mu_s = src.mean(axis=1, keepdims=True)
    mu_d = dst.mean(axis=1, keepdims=True)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd @ xs.T / src.shape[1]
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    scale = float(np.trace(np.diag(d) @ s) / np.mean(np.sum(xs**2, axis=0))) if with_scale else 1.0
    trans = (mu_d - scale * rot @ mu_s).ravel()
    return rot, trans, scale


class ATEResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    errors: np.ndarray


def ate(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True) -> ATEResult:
    """Absolute trajectory error over associated position pairs (evo's
    ate_rmse with SE(3) Umeyama alignment)."""
    est = np.asarray(est_positions, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_positions, np.float64).reshape(-1, 3)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align and est.shape[0] >= 3:
        rot, trans, _ = umeyama_alignment(est, gt)
        est = est @ rot.T + trans
    err = np.linalg.norm(est - gt, axis=1)
    return ATEResult(rmse=float(np.sqrt(np.mean(err**2))), mean=float(np.mean(err)),
                     median=float(np.median(err)), max=float(np.max(err)), errors=err)


def rpe(est_positions: np.ndarray, gt_positions: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over `delta`-step pairs."""
    est = np.asarray(est_positions, np.float64).reshape(-1, 3)
    gt = np.asarray(gt_positions, np.float64).reshape(-1, 3)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


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

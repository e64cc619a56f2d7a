#!/usr/bin/env python3
"""Dense against PCG pose-graph solves of the PyTorch port on one NVIDIA GPU.

The counterpart of tools/diag_graphsolve.py, with its graph and buckets:

    python tools/torch_diag_graphsolve.py [--buckets 128 256 512 1024 2048] [--reps 3]

The large test graph of tests/test_graph.py (`TestScaleVsOracle`, copied
here in numpy: 2,048 poses on four laps of a circle, exact odometry and a
drifted estimate, 50 loop and 20 prior-style factors), cut at each capacity
bucket to its first K poses and the factors among them, then solved by
"dense" and "pcg" (the chain preconditioner) from the drifted estimate.
Per bucket and method: the mean wall ms of `--reps` synchronized solves
after a warm one, the largest distance of a solved position from the truth
(and the start's), chi^2, whether Gauss-Newton converged, and its iteration
count.

Prints one JSON line per bucket and method, beside the card's nvidia-smi
name and power limit. Writes no file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

BUCKETS = (128, 256, 512, 1024, 2048)
METHODS = ("dense", "pcg")


def big_graph(k: int = 2048, n_loops: int = 50, n_priors: int = 20):
    """tests/test_graph.py:137-185 (`TestScaleVsOracle._big_graph`): (true_rot,
    true_trans, odom_rot, odom_trans, est_rot, est_trans, loops, priors),
    numpy f64; each factor (i, j, rel_rot, rel_trans, noise_var, robust_c)."""
    rng = np.random.default_rng(7)
    laps = 4
    th = np.linspace(0, laps * 2 * np.pi, k, endpoint=False)
    true_trans = np.stack([40 * np.cos(th), 40 * np.sin(th), 2 * np.sin(3 * th)], axis=-1)
    yaw = th + np.pi / 2
    true_rot = np.zeros((k, 3, 3))
    c, s = np.cos(yaw), np.sin(yaw)
    true_rot[:, 0, 0] = c
    true_rot[:, 0, 1] = -s
    true_rot[:, 1, 0] = s
    true_rot[:, 1, 1] = c
    true_rot[:, 2, 2] = 1.0
    odom_rot = np.zeros((k, 3, 3))
    odom_trans = np.zeros((k, 3))
    odom_rot[0] = np.eye(3)
    est_rot = np.zeros((k, 3, 3))
    est_trans = np.zeros((k, 3))
    est_rot[0] = true_rot[0]
    est_trans[0] = true_trans[0]
    for i in range(1, k):
        odom_rot[i] = true_rot[i - 1].T @ true_rot[i]
        odom_trans[i] = true_rot[i - 1].T @ (true_trans[i] - true_trans[i - 1])
        noisy_t = odom_trans[i] + rng.normal(0, 0.01, 3)
        est_rot[i] = est_rot[i - 1] @ odom_rot[i]
        est_trans[i] = est_rot[i - 1] @ noisy_t + est_trans[i - 1]
    per_lap = k // laps
    loops = []
    for n in range(n_loops):
        j = int(rng.integers(per_lap, k - 1))
        i = j - per_lap  # the same spot one lap earlier
        rel_r = true_rot[i].T @ true_rot[j]
        rel_t = true_rot[i].T @ (true_trans[j] - true_trans[i])
        loops.append((i, j, rel_r, rel_t, np.full(6, 1e-4), 1.0 if n % 2 else 0.0))
    priors = []
    for _ in range(n_priors):
        j = int(rng.integers(1, k - 1))
        i = max(j - 3, 0)
        rel_r = true_rot[i].T @ true_rot[j]
        rel_t = true_rot[i].T @ (true_trans[j] - true_trans[i])
        priors.append((i, j, rel_r, rel_t, np.array([1e-4, 1e-4, 1e-2, 1e-2, 1e-2, 1e-4]), 0.0))
    return true_rot, true_trans, odom_rot, odom_trans, est_rot, est_trans, loops, priors


def build(k_cap: int, data, device):
    """diag_graphsolve.py:27-48: the graph of the first k_cap poses of
    `data` (a `big_graph()`), and its start (rot0, trans0, count)."""
    from rolo_tpu_torch.graph import add_between, empty_graph

    true_rot, true_trans, odom_rot, odom_trans, est_rot, est_trans, loops, priors = data
    n = k_cap

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    ort = np.broadcast_to(np.eye(3), (k_cap, 3, 3)).copy()
    otr = np.zeros((k_cap, 3))
    ort[:n], otr[:n] = odom_rot[:n], odom_trans[:n]
    graph = empty_graph(k_cap, 64, 32, device)
    graph = graph._replace(odom_rel_rot=t(ort), odom_rel_trans=t(otr),
                           first_rot=t(true_rot[0]), first_trans=t(true_trans[0]))
    lf, pf = graph.loops, graph.priors
    for (i, j, rr, rt, var, rc) in loops:
        if i < n and j < n:
            lf = add_between(lf, i, j, t(rr), t(rt), t(var), robust_c=t(rc))
    for (i, j, rr, rt, var, _) in priors:
        if i < n and j < n:
            pf = add_between(pf, i, j, t(rr), t(rt), t(var))
    graph = graph._replace(loops=lf, priors=pf)
    er = np.broadcast_to(np.eye(3), (k_cap, 3, 3)).copy()
    et = np.zeros((k_cap, 3))
    er[:n], et[:n] = est_rot[:n], est_trans[:n]
    return graph, t(er), t(et), torch.tensor(n, dtype=torch.int32, device=device)


def compare(k_cap: int, data, device, reps: int = 3, methods=METHODS, warm: bool = True):
    """diag_graphsolve.py:51-85 at one bucket: ({method: row}, {method:
    solution}); each time the mean of `reps` synchronized solves, after an
    untimed one when `warm`."""
    from rolo_tpu_torch.graph import solve_pose_graph

    device = torch.device(device)
    graph, rot0, trans0, cnt = build(k_cap, data, device)
    true_trans = data[1][:k_cap]
    start_err = float(np.linalg.norm(trans0.cpu().double().numpy() - true_trans, axis=1).max())
    rows, sols = {}, {}
    for method in methods:
        def solve():
            return solve_pose_graph(graph, rot0, trans0, cnt, method=method)

        if warm:
            solve()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            sol = solve()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / reps * 1e3
        err = np.linalg.norm(sol.trans.cpu().double().numpy() - true_trans, axis=1)
        rows[method] = {"k": k_cap, "method": method, "ms": ms, "max_t_err_m": float(err.max()),
                        "start_max_t_err_m": start_err, "chi2": float(sol.final_error),
                        "converged": bool(sol.converged), "iterations": int(sol.iterations)}
        sols[method] = sol
    return rows, sols


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=list(BUCKETS))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diag_graphsolve.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import bench_metadata, configure_precision

    configure_precision()
    data = big_graph()
    for k_cap in args.buckets:
        rows, _ = compare(k_cap, data, torch.device("cuda"), args.reps)
        for row in rows.values():
            print(json.dumps(row), flush=True)
    print(json.dumps({"machine": bench_metadata()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Decomposition of the PyTorch port's dense pose-graph solve on one NVIDIA GPU.

The counterpart of tools/diag_dense_solve.py, with its graph and rows:

    python tools/torch_diag_dense_solve.py [--buckets 256 512 1024 2048] [--reps 3]

At each capacity bucket K, an odometry chain of K poses 0.7 m apart (noise
0.02 m) with 24 loop factors of bounded span, solved from the integrated
odometry: one linearization (`graph/solver._linearize`), the dense Hessian's
assembly (`_dense_hessian`, 6K x 6K), its Cholesky factor, one solve against
it, the whole dense solve with its Gauss-Newton iteration count, and the
"bcr" solve (block-cyclic reduction + Woodbury) with its distance from the
dense solution and both chi^2. Each time is the mean over `--reps`
synchronized calls after a warm one. The dense Hessian at K = 2,048 is a
12,288^2 f32 matrix (0.6 GB); it and its factor are freed after each bucket.

Prints one JSON line per bucket (the reference's `ms_*` names), beside the
card's nvidia-smi name and power limit. Writes no file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

BUCKETS = (256, 512, 1024, 2048)


def synth_arrays(k: int, n_loops: int = 24, seed: int = 0):
    """diag_dense_solve.py:32-56 in numpy: (odometry translations [k, 3],
    loops [(i, j, rel_trans [3])]); every relative rotation is the
    identity, each loop's noise variance 1e-2 and no robust kernel."""
    rng = np.random.default_rng(seed)
    rel_t = np.tile(np.array([0.7, 0.0, 0.0], np.float32), (k, 1))
    rel_t += rng.normal(0, 0.02, rel_t.shape).astype(np.float32)
    loops = []
    for _ in range(n_loops):
        i = int(rng.integers(0, k - 10))
        j = int(rng.integers(i + 5, min(i + 200, k)))  # bounded span, as the reference
        loops.append((i, j, rel_t[i + 1:j + 1].sum(0).astype(np.float32)))
    return rel_t, loops


def synth(k: int, device, n_loops: int = 24, seed: int = 0):
    """The port's PoseGraph of `synth_arrays` at capacity k (64 loop and 32
    prior slots), and the start: (graph, rot [k, 3, 3], trans [k, 3])."""
    from rolo_tpu_torch.graph import add_between, empty_graph

    rel_t, loops = synth_arrays(k, n_loops, seed)
    eye = torch.eye(3, device=device)
    graph = empty_graph(k, 64, 32, device)
    graph = graph._replace(odom_rel_rot=eye.repeat(k, 1, 1),
                           odom_rel_trans=torch.as_tensor(rel_t, device=device))
    loop_f = graph.loops
    for i, j, rt in loops:
        loop_f = add_between(loop_f, i, j, eye, torch.as_tensor(rt, device=device),
                             torch.full((6,), 1e-2, device=device),
                             robust_c=torch.tensor(0.0, device=device))
    graph = graph._replace(loops=loop_f)
    return graph, eye.repeat(k, 1, 1), torch.cumsum(graph.odom_rel_trans, dim=0)


def _timeit(fn, device, reps: int):
    """(mean ms of `reps` synchronized calls after a warm one, last output)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        sync()
    return (time.perf_counter() - t0) / reps * 1e3, out


def decompose(k: int, device, reps: int = 3):
    """diag_dense_solve.py:70-110 at bucket k: (row, dense solution, bcr
    solution)."""
    from rolo_tpu_torch.graph import solve_pose_graph
    from rolo_tpu_torch.graph.solver import _cholesky, _dense_hessian, _linearize

    device = torch.device(device)
    graph, rot, trans = synth(k, device)
    count = torch.tensor(k, dtype=torch.int32, device=device)
    active = (torch.arange(k, device=device) < count)[:, None]
    ms_lin, blocks = _timeit(lambda: _linearize(graph, rot, trans, count), device, reps)
    ms_asm, h = _timeit(lambda: _dense_hessian(blocks, k, 1e-6, active), device, reps)
    ms_chol, cf = _timeit(lambda: _cholesky(h), device, reps)
    rhs = torch.ones(k * 6, 1, device=device)
    ms_solve, _ = _timeit(lambda: torch.cholesky_solve(rhs, cf), device, reps)
    del blocks, h, cf
    ms_full, sol = _timeit(lambda: solve_pose_graph(graph, rot, trans, count, method="dense"),
                           device, reps)
    ms_bcr, sol_b = _timeit(lambda: solve_pose_graph(graph, rot, trans, count, method="bcr"),
                            device, reps)
    row = {"k": k, "ms_lin": ms_lin, "ms_asm": ms_asm, "ms_chol": ms_chol, "ms_solve": ms_solve,
           "per_iteration_floor_ms": ms_lin + ms_asm + ms_chol + ms_solve,
           "ms_full": ms_full, "dense_iterations": int(sol.iterations),
           "ms_bcr": ms_bcr, "bcr_iterations": int(sol_b.iterations),
           "max_trans_diff_bcr_vs_dense_m": float((sol.trans - sol_b.trans).abs().max()),
           "chi2_dense": float(sol.final_error), "chi2_bcr": float(sol_b.final_error)}
    return row, sol, sol_b


def free(device) -> None:
    """Give the dense Hessians' memory back to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", type=int, nargs="+", default=list(BUCKETS))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diag_dense_solve.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import bench_metadata, configure_precision

    configure_precision()
    device = torch.device("cuda")
    for k in args.buckets:
        row, _, _ = decompose(k, device, args.reps)
        free(device)
        print(json.dumps(row), flush=True)
    print(json.dumps({"machine": bench_metadata()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

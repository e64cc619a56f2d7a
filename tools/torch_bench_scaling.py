#!/usr/bin/env python3
"""Strong scaling of batched registrations over process groups on the
card(s): the counterpart of tools/bench_scaling.py.

    python tools/torch_bench_scaling.py [--points 1024] [--batch 16] [--voxel-capacity 2048]
                                        [--repeats 3] [--ranks N] [--out FILE]

The same total batch of scan pairs (the reference's four noisy walls, seed
0) is registered by groups of s = 1, 2, 4, 8, 16, 32 ranks, s <= N (--ranks,
by default the visible cards), each rank its `shard_registration_inputs`
slice through `registration_batch` (k = 10, `RegistrationConfig()`). A row
is one group of s spawned processes on a TCP store at a free port, since a
mesh spans its whole group: rank r on card r % cards, NCCL when no two ranks
share a card and gloo otherwise (NCCL refuses two ranks on one card). One
warm call, then the best of --repeats, each the wall between two group
barriers on rank 0. With N >= 8 one more row runs on a 2 x 4 ("host",
"batch") pod mesh, `shard_batch_pod` slices. Rows keep the reference's keys
and add `n_physical_cores`, `cards`, `ranks_exceed_cards` and `backend`:
a row whose ranks share a card measures how the card time-slices between
processes, not scaling across cards.

Prints each row as a JSON line, then the report with the card's nvidia-smi
name and power limit. Needs a CUDA device; writes a file only to --out.
The functions take a device: on "cpu" every group runs gloo on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rolo_tpu_torch.parallel.launch import TIMEOUT_S, time_group, visible_cards  # noqa: E402

SIZES = (1, 2, 4, 8, 16, 32)


def row(s: int, b: int, t: float, t1: float, cards: int, backend: str) -> dict:
    """tools/bench_scaling.py:101-109's row, with the host's cores (two
    host-bound ranks need two) and the cards it ran on."""
    speedup = t1 / t
    return {
        "devices": s, "total_batch": b, "time_s": round(t, 4),
        "regs_per_s": round(b / t, 2),
        "speedup_vs_1dev": round(speedup, 3),
        "parallel_efficiency": round(speedup / s, 3),
        "devices_exceed_physical_cores": s > os.cpu_count(),
        "n_physical_cores": os.cpu_count(),
        "cards": min(s, cards), "ranks_exceed_cards": s > cards, "backend": backend,
    }


def measure(points: int = 1024, batch: int = 16, voxel_capacity: int = 2048, repeats: int = 3,
            ranks: int = None, device="cuda", timeout: float = TIMEOUT_S):
    """(rows, pod row or None), each row printed as a JSON line as it comes."""
    cards = visible_cards(device)
    ranks = cards if ranks is None else ranks
    rows, t1 = [], None
    for s in (s for s in SIZES if s <= ranks):
        res = time_group(s, points, batch, voxel_capacity, repeats, device, cards,
                         timeout=timeout)
        t1 = res["time_s"] if t1 is None else t1
        rows.append(row(s, batch, res["time_s"], t1, cards, res["backend"]))
        print(json.dumps(rows[-1]), flush=True)
    pod_row = None
    if ranks >= 8:
        res = time_group(8, points, batch, voxel_capacity, repeats, device, cards, pod=True,
                         timeout=timeout)
        pod_row = {"mesh": "2x4 (host,batch)", **row(8, batch, res["time_s"], t1, cards,
                                                      res["backend"])}
        print(json.dumps(pod_row), flush=True)
    return rows, pod_row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=16, help="TOTAL batch (shared across ranks)")
    ap.add_argument("--voxel-capacity", type=int, default=2048)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="largest group (default: the visible cards; more share cards over gloo)")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_scaling.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import bench_metadata

    rows, pod_row = measure(args.points, args.batch, args.voxel_capacity, args.repeats,
                            args.ranks, "cuda")
    report = {
        "metric": "strong-scaling speedup (t_1rank / t_nranks, same total batch)",
        "mode": "strong",
        "note": ("one process per rank, rank r on card r % cards: rows where "
                 "ranks_exceed_cards share a card over gloo and measure its time-slicing "
                 "between processes, not scaling across cards"),
        "n_physical_cores": os.cpu_count(),
        "rows": rows,
        "pod_2d_mesh": pod_row,
        "machine": bench_metadata(),
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

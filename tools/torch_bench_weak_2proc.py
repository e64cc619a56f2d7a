#!/usr/bin/env python3
"""Weak scaling across two OS processes on the card(s): the counterpart of
tools/bench_weak_2proc.py.

    python tools/torch_bench_weak_2proc.py [--points 1024] [--per-dev-batch 8] [--out FILE]

A constant per-rank registration batch: one process registering its
--per-dev-batch pairs, then a group of two, each its own --per-dev-batch
slice of a batch built as tools/bench_weak_2proc.py:51-59 builds it
(`registration_batch`, k = 10, voxel capacity 2,048, `RegistrationConfig()`).
Each group is spawned on a TCP store at a free port
(`rolo_tpu_torch.parallel.launch.time_group`: one warm call, then the best
of three, each the wall between two group barriers on rank 0). The two
ranks sit on cards of their own over NCCL where there are two, and share
card 0 over gloo otherwise; then weak_efficiency = t_1proc / t_2proc says
what a second process on the same card costs the first. The row keeps the
reference's keys and adds `cards`, `ranks_per_card` and `backend`.

Prints the row as one JSON line, with the card's nvidia-smi name and power
limit under "machine". Needs a CUDA device; writes a file only to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rolo_tpu_torch.parallel.launch import TIMEOUT_S, time_group, visible_cards  # noqa: E402

VOXEL_CAPACITY = 2048  # tools/bench_weak_2proc.py:62
REPEATS = 3


def measure(points: int = 1024, per_dev_batch: int = 8, device="cuda", repeats: int = REPEATS,
            timeout: float = TIMEOUT_S) -> dict:
    """One process, then two, at `per_dev_batch` pairs a rank: the row
    (tools/bench_weak_2proc.py:117-127, with the cards it ran on)."""
    cards = visible_cards(device)
    one = time_group(1, points, per_dev_batch, VOXEL_CAPACITY, repeats, device, cards,
                     timeout=timeout)
    two = time_group(2, points, 2 * per_dev_batch, VOXEL_CAPACITY, repeats, device, cards,
                     timeout=timeout)
    return {
        "mode": "weak (constant per-rank batch, 2 OS processes, "
                + ("a card each)" if two["backend"] == "nccl" else "sharing one device)"),
        "per_device_batch": per_dev_batch,
        "points": points,
        "t_1proc_s": round(one["time_s"], 4),
        "t_2proc_s": round(two["time_s"], 4),
        "regs_per_s_1proc": round(per_dev_batch / one["time_s"], 2),
        "regs_per_s_2proc_total": round(2 * per_dev_batch / two["time_s"], 2),
        "weak_efficiency": round(one["time_s"] / two["time_s"], 3),
        "n_physical_cores": os.cpu_count(),
        "cards": min(2, cards),
        "ranks_per_card": 1 if two["backend"] == "nccl" else 2,
        "backend": two["backend"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--per-dev-batch", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the row here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_weak_2proc.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import bench_metadata

    row = {**measure(args.points, args.per_dev_batch), "machine": bench_metadata()}
    print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

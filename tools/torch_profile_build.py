#!/usr/bin/env python3
"""Micro-profile of the PyTorch port's voxel-map build and lookup on one NVIDIA GPU.

The counterpart of tools/profile_build.py, with its workload and rows:

    python tools/torch_profile_build.py [--iters 8] [--batch 16] [--n 4096] [--out FILE]

On `--batch` synthetic four-plane feature clouds of `--n` points and their
covariances: the whole `build_voxel_map` at each capacity, the packing and
sort alone, the K1 build alone (the keyed sum of the [10, n] point moments
into the table's slots, the keys already sorted) at each capacity, and a
lookup of every point's voxel by searchsorted + gather against the K1 join.
The reference chains its iterations inside one compiled program; here each
row runs `--iters` dependent calls (each call's input moved by 1e-12 of the
last output's sum) ending in one synchronize (`ms`). The K1 calls and both
lookups are also captured in a CUDA graph and replayed (`device_ms`, as
`chip_smoke.py` phase 2 times its kernels): the card's time without the
host's launch overhead. The build clamps its capacity to the point count
rounded up to 128 (`voxel/voxelmap.py`), so both capacities build the same
table when `--n` is below them.

Prints one JSON line per row, then the report, beside the card's nvidia-smi
name and power limit. Writes the report to `--out` only when given. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

CAPS = (8192, 4096)


def profile(device, batch: int = 16, n: int = 4096, iters: int = 8, cfg=None) -> dict:
    """Every row of profile_build.py:40-97 on `device`, as a report."""
    from rolo_tpu_torch.bench import graph_ms
    from rolo_tpu_torch.config import RegistrationConfig
    from rolo_tpu_torch.graft_entry import _synthetic_features
    from rolo_tpu_torch.ops.voxel_join import INVALID_PACK, keyed_matmul, pack_polar
    from rolo_tpu_torch.runtime.platform import bench_metadata
    from rolo_tpu_torch.voxel.knn import estimate_cov6
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map, polar_coord

    device = torch.device(device)
    cuda = device.type == "cuda"
    cfg = RegistrationConfig() if cfg is None else cfg
    polar = tuple(cfg.polar_resolution)
    src = torch.stack([torch.as_tensor(_synthetic_features(n, seed=i)) for i in range(batch)])
    src = src.to(device)
    mask = torch.ones(batch, n, dtype=torch.bool, device=device)
    cov = estimate_cov6(src, mask, k=20, method=cfg.regularization)
    rows = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def chain_time(name, fn, x, device_fn=None):
        """fn: x -> a tensor; `iters` calls, each on x moved by the last
        output's sum times 1e-12."""
        out = fn(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            x = x + out.sum() * 1e-12
            out = fn(x)
        sync()
        rows[name] = {"ms": (time.perf_counter() - t0) / iters * 1e3}
        if cuda and device_fn is not None:
            rows[name]["device_ms"] = graph_ms(device_fn)

    def pack_of(x):
        return pack_polar(polar_coord(x, polar)).to(torch.int32)

    for cap in CAPS:
        chain_time(f"build_voxel_map cap={cap}",
                   lambda x, cap=cap: build_voxel_map(x, cov, mask, cap, polar_res=polar).mean, src)
    chain_time("pack+sort", lambda x: torch.sort(pack_of(x), dim=-1).values, src)

    # the K1 build alone: the point moments in key order, summed into a
    # fixed table (the first `cap` sorted packs, or all of them padded)
    pack0 = pack_of(src)
    table, order = torch.sort(pack0, dim=-1, stable=True)
    data = torch.cat([torch.ones(batch, 1, n, device=device), src.transpose(1, 2), cov], dim=1)
    data = torch.gather(data, 2, order[:, None, :].expand(-1, data.shape[1], -1)).contiguous()
    for cap in CAPS:
        tb = table[:, :cap] if cap <= n else torch.nn.functional.pad(
            table, (0, cap - n), value=INVALID_PACK)
        tb = tb.contiguous()

        def k1_build(tb=tb):
            return keyed_matmul(data, table, tb, keys_sorted=True)

        chain_time(f"keyed_matmul build [10,{n}]x[{cap}]", lambda x, f=k1_build: f(), src, k1_build)

    # every point's voxel stats: searchsorted + gather against the K1 join
    def ss_gather(q):
        idx = torch.clamp(torch.searchsorted(table, q), 0, n - 1)
        found = torch.gather(table, 1, idx) == q
        stats = torch.gather(data, 2, idx[:, None, :].expand(-1, data.shape[1], -1))
        return torch.where(found[:, None, :], stats, 0.0)

    chain_time("searchsorted+gather lookup", lambda x: ss_gather(pack_of(x)), src,
               lambda: ss_gather(pack0))
    chain_time("keyed_matmul lookup",
               lambda x: keyed_matmul(data, table, pack_of(x), keys_sorted=True), src,
               lambda: keyed_matmul(data, table, pack0, keys_sorted=True))
    return {"shapes": {"batch": batch, "n": n, "capacities": list(CAPS)}, "iters": iters,
            "rows": rows, "machine": bench_metadata()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--out", default=None, help="write the report here (JSON)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_build.py needs a CUDA device")
    from rolo_tpu_torch.runtime.platform import configure_precision

    configure_precision()
    report = profile(torch.device("cuda"), args.batch, args.n, args.iters)
    for row, value in report["rows"].items():
        print(json.dumps({"row": row, **value}))
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Groups of spawned ranks on one host, and the scaling tools' timed group.

A mesh spans its whole process group (`mesh.make_mesh`), so a group of s
ranks is s fresh processes on a TCP store at a free port (`run_ranks`):
rank r on card r % cards, NCCL when no two ranks share a card and gloo
otherwise (`backend_for`; NCCL refuses two ranks on one card). The group
stops at the first non-zero exit, since its peers would wait in a
collective, and raises with that rank's output.

`time_group` is the measurement of tools/torch_bench_scaling.py and
tools/torch_bench_weak_2proc.py: each rank registers its slice of the
reference tools' batch (`inputs`) through `registration_batch`, once warm,
then the best of `repeats` on rank 0, each the wall between two group
barriers. Its ranks run this module:

    python -m rolo_tpu_torch.parallel.launch SPEC
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List

import numpy as np

# the directory holding the package: the ranks' working directory and path
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
K = 10
TIMEOUT_S = 900  # a group's processes, as tools/bench_weak_2proc.py:91 waits for its workers


def backend_for(ranks: int, cards: int, device: str) -> str:
    """NCCL when every rank has a card of its own, else gloo (gloo shares a
    card; on the CPU it is the only choice)."""
    return "nccl" if device == "cuda" and ranks <= cards else "gloo"


def visible_cards(device) -> int:
    import torch

    return torch.cuda.device_count() if str(device) == "cuda" else 0


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(argv: Callable[[int, int], List[str]], nproc: int,
              timeout: float = TIMEOUT_S) -> List[str]:
    """Start `argv(rank, port)` for every rank of an nproc group on one free
    port, and return each rank's output (stdout and stderr). Raises, after
    stopping every process, when a rank exits non-zero (with its output) or
    the group outlives `timeout` seconds (a rank left waiting in a
    collective)."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)  # the group is the tcp:// store below, not a launcher's
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timed_out, killed = False, []
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(nproc)]
        procs = [subprocess.Popen(argv(r, port), cwd=ROOT, env=env, stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True) for r in range(nproc)]
        try:
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(c not in (None, 0) for c in codes):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.1)
        finally:
            killed = [r for r, p in enumerate(procs) if p.poll() is None]
            for r in killed:
                procs[r].kill()
            outs = []
            for p, log in zip(procs, logs):
                p.wait()
                log.seek(0)
                outs.append(log.read())
                log.close()
    if timed_out:
        raise RuntimeError(f"a group of {nproc} ranks outlived {timeout} s (a rank waiting in a "
                           "collective):\n" + "\n".join(f"rank {r}: {out[-2000:]}"
                                                        for r, out in enumerate(outs)))
    for r, p in enumerate(procs):
        if p.returncode != 0 and r not in killed:
            raise RuntimeError(f"rank {r} of {nproc} exited {p.returncode}:\n{outs[r][-6000:]}")
    return outs


def result_of(out: str) -> dict:
    """The JSON a rank printed on its RESULT line."""
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line.split(" ", 1)[1])


def inputs(n: int, b: int):
    """(src [b, n, 3], tgt [b, n, 3], masks [b, n]) as tools/bench_scaling.py:60-70
    builds them: four-wall features, each rotated about z by 0.01-0.05 rad
    and shifted by up to 0.3 m."""
    from ..graft_entry import _synthetic_features

    rng = np.random.default_rng(0)
    src = np.stack([_synthetic_features(n, seed=i) for i in range(b)])
    ang = rng.uniform(0.01, 0.05, b)
    tgt = np.stack([
        s @ np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                     np.float32).T
        + rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        for s, a in zip(src, ang)
    ])
    masks = np.ones((b, n), bool)
    return src, tgt, masks


def rank_inputs(mesh, n: int, b: int, device, pod: bool = False):
    """This rank's slice of the b-pair batch: `shard_registration_inputs`
    over the mesh's "batch" axis, or `shard_batch_pod` over a pod mesh
    (tools/bench_scaling.py:74-88)."""
    import torch

    from .batch import ShardedRegistrationInputs, shard_registration_inputs
    from .mesh import shard_batch_pod

    src, tgt, masks = (torch.tensor(x, device=device) for x in inputs(n, b))
    if not pod:
        return shard_registration_inputs(mesh, src, masks, tgt, masks)
    dt = torch.full((b,), 0.1, device=device)
    zero = torch.zeros(b, 3, device=device)
    return shard_batch_pod(ShardedRegistrationInputs(src, masks, tgt, masks, zero, zero, dt, dt),
                           mesh)


def worker(spec: dict) -> int:
    """One rank of `time_group`'s group: join it, register this rank's
    slice once warm, then time `repeats` calls between group barriers.
    Prints RESULT with this rank's best wall seconds."""
    import torch
    import torch.distributed as dist

    from ..config import RegistrationConfig
    from ..runtime.platform import configure_precision
    from .batch import registration_batch
    from .mesh import distributed_init, make_mesh, make_pod_mesh

    torch.set_num_threads(1)
    configure_precision()
    rank, world = spec["rank"], spec["world"]
    distributed_init(f"localhost:{spec['port']}", world, rank, backend=spec["backend"])
    device = torch.device(spec["device"])
    if spec["pod"]:
        mesh = make_pod_mesh(n_hosts=2, devices_per_host=world // 2, device_type=device.type)
    else:
        mesh = make_mesh(world, device_type=device.type)
    args = rank_inputs(mesh, spec["points"], spec["batch"], device, spec["pod"])
    cfg = RegistrationConfig()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def once() -> float:
        dist.barrier()
        t0 = time.perf_counter()
        registration_batch(*args, cfg=cfg, voxel_capacity=spec["voxel_capacity"], k=K)
        sync()
        dist.barrier()
        return time.perf_counter() - t0

    once()  # warm
    best = min(once() for _ in range(spec["repeats"]))
    print("RESULT " + json.dumps({"rank": rank, "time_s": best,
                                  "batch": int(args.src_xyz.shape[0])}), flush=True)
    dist.destroy_process_group()
    return 0


def time_group(nproc: int, points: int, batch: int, voxel_capacity: int, repeats: int, device,
               cards: int, pod: bool = False, timeout: float = TIMEOUT_S) -> dict:
    """One group of nproc spawned ranks registering `batch` pairs between
    them: rank 0's RESULT, with the backend the group ran."""
    backend = backend_for(nproc, cards, str(device))
    spec = {"world": nproc, "points": points, "batch": batch, "voxel_capacity": voxel_capacity,
            "repeats": repeats, "device": str(device), "backend": backend, "pod": pod}
    outs = run_ranks(lambda r, port: [sys.executable, "-m", "rolo_tpu_torch.parallel.launch",
                                      json.dumps({**spec, "rank": r, "port": port})],
                     nproc, timeout)
    return {**result_of(outs[0]), "backend": backend}


if __name__ == "__main__":
    sys.exit(worker(json.loads(sys.argv[1])))

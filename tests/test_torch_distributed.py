"""Two processes on localhost in one gloo group (modelled on
tests/test_distributed.py): the port's parallel/ layer across a real
process boundary. Each worker runs

  - a ("host", "batch") 2 x 1 pod mesh: its shard_batch_pod slice of an
    8-row batch and a cross-process sum;
  - register_scan_pair_spmd over both ranks on tests/test_parallel.py's
    SPMD scene (1,024 points, k = 10, voxel capacity 2,048), against
    register_scan_pair in one process, and the applied motion recovered, at
    that test's tolerances. The shards differ on purpose: rank 1's half has
    a third of its points masked, so a branch on a rank's own value would
    leave the other rank waiting in a collective, and the worker's timeout
    fails the test;
  - a point count the group does not divide, refused on both ranks;
  - dryrun_multichip(2) on the CPU.

And a launcher's env:// group (`torch.distributed.run`) joined through
distributed_init() with no arguments: two gloo ranks on the CPU, and on a
machine with two or more cards one NCCL rank a card (marked `cuda`).
"""

import os
import subprocess
import sys

import pytest
import torch

from rolo_tpu_torch.parallel.launch import ROOT, result_of, run_ranks

_WORKER = r"""
import sys
port, pid = sys.argv[1], int(sys.argv[2])
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)

from rolo_tpu_torch.config import RegistrationConfig
from rolo_tpu_torch.graft_entry import dryrun_multichip
from rolo_tpu_torch.parallel.mesh import distributed_init, make_mesh, make_pod_mesh, shard_batch_pod
from rolo_tpu_torch.parallel.spmd import register_scan_pair_spmd
from rolo_tpu_torch.registration.rotgicp import register_scan_pair

assert distributed_init(f"localhost:{port}", 2, pid, backend="gloo")
assert dist.get_world_size() == 2 and dist.get_rank() == pid

# the pod mesh: host-major slices of an 8-row batch, summed across processes
pod = make_pod_mesh(device_type="cpu")
assert pod.mesh_dim_names == ("host", "batch") and pod.size(0) == 2 and pod.size(1) == 1
rows = torch.arange(8.0)[:, None] * torch.ones(1, 16)
mine, whole = shard_batch_pod((rows, torch.zeros(3)), pod)
assert mine.shape == (4, 16) and float(mine[0, 0]) == 4.0 * pid and whole.shape == (3,)
total = mine.sum()
dist.all_reduce(total)
assert float(total) == float(rows.sum()), (float(total), float(rows.sum()))


def structured(n, seed):  # tests/test_parallel.py's _structured
    rng = np.random.default_rng(seed)
    walls = []
    for nv, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0, 0, 1), -1.5), ((0.7, 0.7, 0), 12.0)]:
        m = n // 4
        nv = np.array(nv, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0] if abs(nv[2]) < 0.9 else [1.0, 0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        u = rng.uniform(-5, 5, (m, 2))
        walls.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    pts = np.concatenate(walls)[:n].astype(np.float32)
    return pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)


n = 1024
src = structured(n, 7)
ang = 0.04
c, s = np.cos(ang), np.sin(ang)
r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
t_true = np.array([0.25, -0.1, 0.02], np.float32)
tgt = (src @ r.T + t_true).astype(np.float32)
mask = np.ones(n, bool)
mask[n // 2::3] = False  # rank 1's shard: a third of its points masked
src_t, tgt_t, mask_t = torch.tensor(src), torch.tensor(tgt), torch.tensor(mask)
zero, dt = torch.zeros(3), torch.tensor(0.1)
cfg = RegistrationConfig()
spmd = register_scan_pair_spmd(make_mesh(axis_names=("point",), device_type="cpu"), src_t,
                               mask_t, tgt_t, mask_t, zero, zero, dt, dt, cfg, 2048, 10)
one = register_scan_pair(src_t[None], mask_t[None], tgt_t[None], mask_t[None], zero[None],
                         zero[None], dt[None], dt[None], cfg, 2048, 10)
np.testing.assert_allclose(spmd.rot.numpy(), one.rot[0].numpy(), atol=2e-4)
np.testing.assert_allclose(spmd.trans.numpy(), one.trans[0].numpy(), atol=2e-3)
np.testing.assert_allclose(spmd.rot.numpy(), r, atol=1.5e-2)
np.testing.assert_allclose(spmd.trans.numpy(), t_true, atol=5e-2)
# both ranks hold the same result
both = torch.stack([spmd.rot.reshape(-1), spmd.trans.repeat(3)])
first = both.clone()
dist.broadcast(first, 0)
assert torch.equal(both, first)

# a point count the group size does not divide: every rank raises before any collective
try:
    register_scan_pair_spmd(None, src_t[:101], mask_t[:101], tgt_t[:101], mask_t[:101], zero,
                            zero, dt, dt, cfg, 2048, 10)
    raise AssertionError("an indivisible point count was accepted")
except ValueError:
    pass

dryrun_multichip(2, device="cpu")
dist.destroy_process_group()
print(f"WORKER_{pid}_OK spmd_vs_one rot {float((spmd.rot - one.rot[0]).abs().max()):.2e} "
      f"trans {float((spmd.trans - one.trans[0]).abs().max()):.2e}")
"""

TIMEOUT_S = 240


def test_two_process_gloo_group(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    outs = run_ranks(lambda pid, port: [sys.executable, str(script), str(port), str(pid)], 2,
                     TIMEOUT_S)
    for pid, out in enumerate(outs):
        assert f"WORKER_{pid}_OK" in out, out[-4000:]


_LAUNCH_WORKER = r"""
import json
import os
import sys
import torch
import torch.distributed as dist
from rolo_tpu_torch.parallel.mesh import distributed_init

assert distributed_init()
on_card = torch.cuda.is_available()
total = torch.tensor([dist.get_rank() + 1.0], device="cuda" if on_card else "cpu")
dist.all_reduce(total)
# one write a line: the ranks share the launcher's stdout
sys.stdout.write("RESULT " + json.dumps({
    "rank": dist.get_rank(), "world": dist.get_world_size(),
    "local_rank": os.environ["LOCAL_RANK"], "backend": dist.get_backend(),
    "card": torch.cuda.current_device() if on_card else None, "sum": float(total)}) + "\n")
sys.stdout.flush()
dist.destroy_process_group()
"""


def _launch(tmp_path, nproc, env):
    """_LAUNCH_WORKER under `torch.distributed.run --standalone` with nproc
    ranks: each rank's RESULT, by rank."""
    script = tmp_path / "launch_worker.py"
    script.write_text(_LAUNCH_WORKER)
    env = {**env, "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", "")}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for name in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(nproc), str(script)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [result_of(line) for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
    return sorted(rows, key=lambda r: r["rank"])


def test_launcher_group_through_distributed_init(tmp_path):
    """Two ranks under `torch.distributed.run`, the cards hidden:
    distributed_init() joins the launcher's env:// group over gloo on the
    CPU, and each rank all-reduces to 1 + 2."""
    rows = _launch(tmp_path, 2, {**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert [(r["rank"], r["world"], r["local_rank"], r["backend"], r["card"], r["sum"])
            for r in rows] == [(0, 2, "0", "gloo", None, 3.0), (1, 2, "1", "gloo", None, 3.0)]


@pytest.mark.cuda
def test_launcher_group_pins_a_card_per_rank(tmp_path):
    """One rank per visible card under `torch.distributed.run`:
    distributed_init() pins rank r to card LOCAL_RANK before NCCL makes the
    group (without the pin every rank takes card 0 and NCCL refuses the
    group as a duplicate GPU), and the all-reduce sums 1 + ... + n."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two or more CUDA devices")
    rows = _launch(tmp_path, cards, dict(os.environ))
    assert [(r["rank"], r["local_rank"], r["backend"], r["card"]) for r in rows] == \
        [(r, str(r), "nccl", r) for r in range(cards)]
    assert all(r["world"] == cards and r["sum"] == cards * (cards + 1) / 2 for r in rows)

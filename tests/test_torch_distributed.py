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
"""

import os
import socket
import subprocess
import sys

import pytest

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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_group(tmp_path):
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(script), str(port), str(pid)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a worker did not finish in {TIMEOUT_S} s (a rank waiting in a collective)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_{pid}_OK" in out, out[-4000:]

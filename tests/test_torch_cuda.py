"""On-card checks of the port's CUDA kernels against their plain torch
versions, and of the CUDA registration path against the CPU one.

These need an NVIDIA GPU with nvcc; elsewhere they skip. They import no JAX,
so on the GPU machine (which has none) run them without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import REL_TOL, plane_rel_err
from torch_parity import lidar_cloud

from rolo_tpu_torch.config import RegistrationConfig
from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_moments import knn_moments, knn_moments_torch
from rolo_tpu_torch.ops.voxel_join import INVALID_PACK, keyed_matmul, keyed_matmul_torch
from rolo_tpu_torch.registration.rotgicp import register_scan_pair
from rolo_tpu_torch.runtime.platform import configure_precision
from rolo_tpu_torch.voxel.knn import moment_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    configure_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["keyed_sum", "knn_moments"])
def test_kernel_builds(cuda, name):
    path, _ = cuda_build.build(name)
    assert path.exists()
    print(cuda_build.BUILD_LOG.get(name, "(reused)"))


@pytest.mark.parametrize("b,s,k,m,sorted_keys", [
    (1, 3, 7, 5, True), (3, 10, 1000, 333, False), (16, 10, 8192, 57344, True)])
def test_keyed_sum_matches_plain(cuda, b, s, k, m, sorted_keys):
    g = torch.Generator(device="cpu").manual_seed(0)
    keys_k = torch.randint(0, 300, (b, k), generator=g, dtype=torch.int32)
    keys_k[:, -k // 10:] = INVALID_PACK
    if sorted_keys:
        keys_k = torch.sort(keys_k, dim=-1).values
    keys_m = torch.randint(0, 320, (b, m), generator=g, dtype=torch.int32)
    keys_m[:, ::7] = INVALID_PACK
    values = torch.randn(b, s, k, generator=g) * 30.0
    values = torch.where((keys_k == INVALID_PACK)[:, None, :], 0.0, values)
    want = keyed_matmul_torch(values, keys_k, keys_m)
    before = keyed_matmul.launches
    got = keyed_matmul(values.to(cuda), keys_k.to(cuda), keys_m.to(cuda),
                       keys_sorted=sorted_keys)
    torch.cuda.synchronize()
    assert keyed_matmul.launches == before + 1
    assert plane_rel_err(got.cpu(), want) < REL_TOL


def _lidar(rng, b, n):
    return torch.as_tensor(np.stack([lidar_cloud(rng, n) for _ in range(b)]))


@pytest.mark.parametrize("b,q,n,k", [(2, 300, 300, 8), (16, 8192, 8192, 20)])
def test_knn_moments_matches_plain(cuda, b, q, n, k):
    rng = np.random.default_rng(1)
    cand = _lidar(rng, b, n)
    cmask = torch.as_tensor(rng.random((b, n)) < 0.9)
    cand = torch.where(cmask[..., None], cand, 0.0)
    xyz, mask = cand[:, :q].contiguous(), cmask[:, :q].contiguous()
    xc = moment_table(cand, cmask).contiguous()
    dev = [t.to(cuda) for t in (xyz, mask, cand, cmask, xc)]
    want = knn_moments_torch(*dev, k)
    got = knn_moments(*dev, k)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])  # membership agrees bit for bit
    assert plane_rel_err(got, want) < REL_TOL


def test_knn_moments_starved_queries(cuda):
    cand = _lidar(np.random.default_rng(2), 1, 256)
    cmask = torch.zeros(1, 256, dtype=torch.bool)
    cmask[:, :8] = True
    cand = torch.where(cmask[..., None], cand, 0.0)
    xc = moment_table(cand, cmask)
    got = knn_moments(*(t.to(cuda) for t in (cand, cmask, cand, cmask, xc)), 20).cpu()
    assert torch.all(got[0, 0, :8] == 8.0)
    assert torch.all(got[0, :, 8:] == 0.0)


def test_registration_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    n = 1024
    planes = []
    for axis, off in [(0, 8.0), (0, -9.0), (1, 10.0), (1, -7.0), (2, -1.5)]:
        p = rng.uniform(-8, 8, (n // 5, 3))
        p[:, axis] = off + rng.normal(0, 0.01, n // 5)
        planes.append(p)
    world = np.concatenate(planes).astype(np.float32)
    c, s = np.cos(0.04), np.sin(0.04)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = torch.tensor(np.stack([world, world]))
    moved = world @ rot.T
    tgt = torch.tensor(np.stack([moved + np.float32([0.2, 0.05, 0.0]), moved]))
    mask = torch.ones(2, world.shape[0], dtype=torch.bool)
    z = torch.zeros(2, 3)
    dt = torch.full((2,), 0.1)
    cfg = RegistrationConfig()
    want = register_scan_pair(src, mask, tgt, mask, z, z, dt, dt, cfg, 2048, 10)
    got = register_scan_pair(*(t.to(cuda) for t in (src, mask, tgt, mask, z, z, dt, dt)), cfg,
                             2048, 10)
    assert torch.allclose(got.rot.cpu(), want.rot, atol=1e-4)
    assert torch.allclose(got.trans.cpu(), want.trans, atol=1e-3)

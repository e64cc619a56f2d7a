"""Where `knn_indices` takes kernel K3 (`ops/knn_select.py`) and where its
plain version: CPU tensors and the elementwise form take the plain chunk
loop, counted as `knn.plain_calls` in a traced stage, and never build or
load the kernel; its wrapper refuses what the kernel does not take. The
kernel itself runs on the card only (`tests/test_torch_cuda.py`).

No JAX here."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import lidar_cloud

from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_select import MAX_K, knn_select, pack_points
from rolo_tpu_torch.runtime.profiling import StageTimers
from rolo_tpu_torch.voxel.knn import knn_indices


def _cloud(seed, b=2, q=70, n=300):
    rng = np.random.default_rng(seed)
    query = torch.as_tensor(np.stack([lidar_cloud(rng, q) for _ in range(b)]))
    pts = torch.as_tensor(np.stack([lidar_cloud(rng, n) for _ in range(b)]))
    pmask = torch.as_tensor(rng.random((b, n)) < 0.8)
    pts = torch.where(pmask[..., None], pts, float("nan"))
    return query, torch.ones(b, q, dtype=torch.bool), pts, pmask


def _traced(fn, stage="backend"):
    timers = StageTimers()
    timers.tracing = True
    with timers.stage(stage):
        out = fn()
    return out, timers.summary()


@pytest.mark.parametrize("form", ["matmul", "elementwise"])
@pytest.mark.parametrize("k", [1, 5, MAX_K, MAX_K + 1])
def test_cpu_tensors_take_the_plain_loop(form, k):
    query, qmask, pts, pmask = _cloud(k)
    before = knn_select.launches
    idx, summary = _traced(lambda: knn_indices(query, qmask, pts, pmask, k, 32, form=form))
    assert idx.shape == (2, 70, k) and idx.dtype == torch.int64
    assert summary["backend.knn.plain_calls"]["total"] == 1.0
    assert "backend.knn.kernel_calls" not in summary
    assert knn_select.launches == before
    assert "knn_select" not in cuda_build._LOADED


def test_untraced_calls_count_nothing():
    query, qmask, pts, pmask = _cloud(3)
    timers = StageTimers()
    with timers.stage("loop_closure"):
        knn_indices(query, qmask, pts, pmask, 1)
    assert not any("knn" in name for name in timers.summary())


@pytest.mark.parametrize("k", [1, 5])
def test_plain_loop_ranks_valid_points_first(k):
    """Invalid (NaN) points never enter; with fewer than k valid points the
    tail points at invalid slots, which callers mask."""
    query, qmask, pts, pmask = _cloud(4, b=1, n=40)
    pmask[0] = torch.arange(40) < 3
    pts = torch.where(pmask[..., None], torch.nan_to_num(pts, nan=25.0), float("nan"))
    idx = knn_indices(query, qmask, pts, pmask, k, 16)
    assert pmask[0, idx[0, :, :min(k, 3)]].all()
    assert not pmask[0, idx[0, :, 3:]].any()


def test_k1_ties_go_to_the_lower_index():
    """The tie rule K3 shares with `torch.argmin`: duplicated points."""
    query, qmask, pts, pmask = _cloud(5, b=1, n=64)
    pmask[:] = True
    pts = torch.cat([pts[:, :32], pts[:, :32]], dim=1)
    idx = knn_indices(query, qmask, pts, pmask, 1, 16)
    assert (idx < 32).all()


def test_pack_points_rows():
    pts = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    xx = torch.tensor([[1.0, float("inf"), 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    rows = pack_points(pts, xx)
    assert rows.shape == (2, 4, 4) and rows.is_contiguous()
    assert torch.equal(rows[..., :3], pts) and torch.equal(rows[..., 3], xx)


@pytest.mark.parametrize("k,n,what", [(1, 8, "CUDA device"), (0, 8, "1 <= k"),
                                      (MAX_K + 1, 64, "1 <= k"), (5, 4, "no 5 neighbours")])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(k, n, what):
    """CPU operands, k outside 1..MAX_K, fewer points than k: refused before
    any build or launch."""
    q, qq, pts4 = torch.zeros(1, 3, 3), torch.zeros(1, 3), torch.zeros(1, n, 4)
    before = knn_select.launches
    with pytest.raises(ValueError, match=what):
        knn_select(q, qq, pts4, k)
    assert knn_select.launches == before
    assert "knn_select" not in cuda_build._LOADED


@pytest.mark.parametrize("shape", [((1, 3, 2), (1, 3), (1, 8, 4)), ((1, 3, 3), (1, 2), (1, 8, 4)),
                                   ((1, 3, 3), (1, 3), (1, 8, 3)), ((1, 3, 3), (1, 3), (2, 8, 4))])
def test_kernel_wrapper_checks_shapes(shape):
    q, qq, pts4 = (torch.zeros(s) for s in shape)
    with pytest.raises(ValueError):
        knn_select(q, qq, pts4, 1)

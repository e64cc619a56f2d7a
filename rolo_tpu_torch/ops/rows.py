"""Guarded single-row writes into fixed-capacity stores.

The reference appends to its stores with `jnp.where(ok, arr.at[i].set(v),
arr)`, which XLA turns into an in-place update. Written literally in torch
that copies the whole store (the keyframe DB is ~0.44 GB at `RoloConfig()`
capacities), so the port writes the one row in place instead. The row index
and the guard stay device tensors: no host sync.
"""

from __future__ import annotations

import torch


def write_row_(arr: torch.Tensor, idx: torch.Tensor, val, ok) -> torch.Tensor:
    """arr[idx] = val where `ok`, in place; idx and ok are 0-dim tensors
    (or Python values). Returns arr."""
    i = torch.as_tensor(idx, device=arr.device).reshape(1).long()
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    ok = torch.as_tensor(ok, device=arr.device)
    old = arr.index_select(0, i)[0]
    arr.index_copy_(0, i, torch.where(ok, val, old)[None])
    return arr

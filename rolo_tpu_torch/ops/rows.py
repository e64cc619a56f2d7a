"""Single-row reads and guarded single-row writes of fixed-capacity stores.

The reference appends to its stores with `jnp.where(ok, arr.at[i].set(v),
arr)`, which XLA turns into an in-place update. Written literally in torch
that copies the whole store (the keyframe DB is ~0.44 GB at `RoloConfig()`
capacities), so the port writes the one row in place instead. The row index
and the guard stay device tensors: no host sync. Reading a row at a device
index (`read_row`) is an index_select for the same reason.
"""

from __future__ import annotations

import torch


def read_row(arr: torch.Tensor, idx) -> torch.Tensor:
    """arr[idx] for a 0-dim index tensor (or a Python int), without a host
    sync."""
    return arr.index_select(0, torch.as_tensor(idx, device=arr.device).reshape(1).long())[0]


def write_row_(arr: torch.Tensor, idx: torch.Tensor, val, ok) -> torch.Tensor:
    """arr[idx] = val where `ok`, in place; idx and ok are 0-dim tensors
    (or Python values). Returns arr."""
    i = torch.as_tensor(idx, device=arr.device).reshape(1).long()
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    ok = torch.as_tensor(ok, device=arr.device)
    arr.index_copy_(0, i, torch.where(ok, val, read_row(arr, i))[None])
    return arr

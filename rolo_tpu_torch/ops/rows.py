"""Single-row reads and guarded single-row writes of fixed-capacity stores.

The reference appends to its stores with `jnp.where(ok, arr.at[i].set(v),
arr)`, which XLA turns into an in-place update. Written literally in torch
that copies the whole store (the keyframe DB is ~0.44 GB at `RoloConfig()`
capacities), so the port writes the one row in place instead. The row index
and the guard stay device tensors: no host sync. Reading a row at a device
index (`read_row`) is an index_select for the same reason.

With a [B] index the store leads with [B] (B instances of it, such as a
batch of back-end states): each instance reads or writes its own row, still
in one call.
"""

from __future__ import annotations

import torch


def _flat_rows(arr: torch.Tensor, idx) -> torch.Tensor:
    """Row numbers into arr viewed as [B * K, ...] for a [B] index."""
    b = torch.arange(arr.shape[0], device=arr.device)
    return b * arr.shape[1] + torch.as_tensor(idx, device=arr.device).long()


def read_row(arr: torch.Tensor, idx) -> torch.Tensor:
    """arr[idx] for a 0-dim index tensor (or a Python int), without a host
    sync; arr[b, idx[b]] for each b of a [B] index."""
    idx = torch.as_tensor(idx, device=arr.device)
    if idx.dim() == 1:
        return arr.reshape(-1, *arr.shape[2:]).index_select(0, _flat_rows(arr, idx))
    return arr.index_select(0, idx.reshape(1).long())[0]


def write_row_(arr: torch.Tensor, idx, val, ok) -> torch.Tensor:
    """arr[idx] = val where `ok`, in place; idx and ok are 0-dim tensors
    (or Python values). With a [B] index, arr [B, K, ...] gets
    arr[b, idx[b]] = val[b] where ok[b] (val and ok [B] or broadcast), as
    one write into the store viewed as [B * K, ...] (a view, never a copy).
    Returns arr."""
    idx = torch.as_tensor(idx, device=arr.device)
    ok = torch.as_tensor(ok, device=arr.device)
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    if idx.dim() == 1:
        flat = arr.view(-1, *arr.shape[2:])
        rows = _flat_rows(arr, idx)
        cur = flat.index_select(0, rows)
        ok = ok.reshape(ok.shape + (1,) * (cur.dim() - ok.dim()))
        flat.index_copy_(0, rows, torch.where(ok, val, cur))
        return arr
    i = idx.reshape(1).long()
    arr.index_copy_(0, i, torch.where(ok, val, arr.index_select(0, i)[0])[None])
    return arr

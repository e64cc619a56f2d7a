"""Segment sums in a fixed order.

A float `index_add_` or `index_put_(accumulate=True)` runs with atomics on
CUDA, so each call may sum a segment in another order and round differently:
two runs of the same step then give other bits. These sums read the values
in a fixed order instead. The ids are stably sorted (sequence order within
each segment, as the CPU scatter-add sums them), each segment is located by
a binary search, and `torch.segment_reduce` sums each segment left to right
(a loop per segment on CUDA, no atomics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Segments(NamedTuple):
    """Where each segment's values lie once sorted by id."""

    order: torch.Tensor  # [M] int64 stable sorting permutation, or None when already sorted
    offsets: torch.Tensor  # [S + 1] int64 start of each segment in sorted order


def segments(ids: torch.Tensor, num_segments: int, is_sorted: bool = False) -> Segments:
    """The segments of ids [M] for `num_segments` outputs. Ids outside
    [0, num_segments) belong to no segment. `is_sorted` skips the sort for
    ids that are already non-decreasing."""
    order = None
    if not is_sorted:
        ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return Segments(order, torch.searchsorted(ids, bounds))


def segment_sum(values: torch.Tensor, segs: Segments) -> torch.Tensor:
    """values [M, ...] -> [S, ...]: each segment's values summed in
    sequence order; an empty segment sums to 0."""
    if segs.order is not None:
        values = values[segs.order]
    return torch.segment_reduce(values, "sum", offsets=segs.offsets, axis=0)

"""Kernel K2's entry as the copied modules call it, computed by the plain
reference (`benchmark/reference/kernels.py`)."""

from __future__ import annotations

from ... import kernels as _plain


def knn_moments(xyz, mask, cand_xyz, cand_mask, xc, k: int):
    return _plain.knn_moments(xyz, mask, cand_xyz, cand_mask, xc, int(k))

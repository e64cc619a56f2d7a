"""The roofline functions against bytes and operations counted by hand."""

from __future__ import annotations

import pytest

from benchmark.roofline import keyed_sum, knn_moments, peaks


def test_knn_moments_counts():
    # B=1, Q=N=8192 (one tensor), S=10: cand xyz 8192*12 + mask 8192 + planes
    # 10*8192*4 in; out 10*8192*4 -> 98304 + 8192 + 327680 + 327680
    assert knn_moments.nbytes(1, 8192, 8192, 10, True) == 761856
    # separate queries add their xyz and mask: 4096 * 13
    assert knn_moments.nbytes(1, 4096, 8192, 10, False) == (98304 + 8192 + 327680
                                                           + 4096 * 13 + 163840)
    # 5,500 valid queries, k = 20, S = 10: 5500 * 20 * 18
    assert knn_moments.flops(5500, 20, 10) == 1980000


def test_keyed_sum_counts():
    # B=16 build over [10, 8192] with its own keys: values 16*10*8192*4,
    # keys 16*8192*4, out 16*10*8192*4
    assert keyed_sum.nbytes(16, 10, 8192, 8192, True) == 5242880 + 524288 + 5242880
    # a join of M=57344 queries adds the query keys
    assert keyed_sum.nbytes(1, 10, 8192, 57344, False) == (327680 + 32768 + 229376
                                                          + 2293760)
    assert keyed_sum.flops(16, 10, 8192, 8192) == 0


def test_bound_takes_the_larger():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e9, 3.35e12) == pytest.approx(1.0)

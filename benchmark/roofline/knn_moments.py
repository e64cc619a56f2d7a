"""Work of one call of kernel K2 (`knn_moments`), reckoned from its operands.

Bytes: every operand read once and the output written once; the query set
counts once where it is the candidate set. Operations: no more than the
outputs need. A valid query's output is the sum of the S moment planes of
its k neighbours, and finding them takes at least the k neighbours' squared
distances (3 subtractions, 3 products, 2 additions each): k * (8 + S)
operations a valid query. That is a lower bound that no correct kernel can
beat, so a kernel that prunes more candidates cannot read above 100%.
(`chip_smoke.py`'s phase 2 counted 8 operations for every valid
query-candidate pair, work that a pruning kernel skips.)
"""

from __future__ import annotations

F32, BOOL = 4, 1


def nbytes(b: int, q: int, n: int, s: int, queries_are_candidates: bool) -> int:
    cand = b * n * (3 * F32 + BOOL) + b * s * n * F32
    query = 0 if queries_are_candidates else b * q * (3 * F32 + BOOL)
    return cand + query + b * s * q * F32


def flops(valid_queries: int, k: int, s: int) -> int:
    return valid_queries * k * (8 + s)

"""Work of one call of kernel K1 (`keyed_matmul`), reckoned from its operands.

Bytes: the S value planes of the K table slots and both key vectors read
once, the [S, M] output written once (keys_m counts once where it is the
table's own keys, as in a voxel build). Operations: a join's output is a
sum over the matching slots, which may be one slot or none, so the least
work the outputs need is no arithmetic at all: the bound is the bytes.
"""

from __future__ import annotations

F32, I32 = 4, 4


def nbytes(b: int, s: int, k: int, m: int, keys_shared: bool) -> int:
    keys = b * k * I32 + (0 if keys_shared else b * m * I32)
    return b * s * k * F32 + keys + b * s * m * F32


def flops(b: int, s: int, k: int, m: int) -> int:
    return 0

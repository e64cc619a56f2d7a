"""Keyed sum (kernel K1): voxel joins and voxel-build segment sums.

Torch port of `rolo_tpu/ops/voxel_join.py`. One primitive serves both the
voxel build and every correspondence rebind:

    out[b, s, m] = sum_k values[b, s, k] * (keys_k[b, k] == keys_m[b, m])

On the TPU this is a one-hot matmul on the MXU (scatters and gathers
serialize there). On Hopper the CUDA kernels of `csrc/keyed_sum.cu` compute
it directly: a join binary-searches each query key in its instance's sorted
keys, staged in shared memory, then sums the matching run in f32; a build
over sorted packs sums each run once. `keyed_matmul_torch` is the plain
version: a chunked equality matmul, the counterpart of `_keyed_matmul_jnp`.

Contract shared with the reference: values at INVALID_PACK keys are zero
(padding, masked points, empty table slots), so a sentinel query sums to 0.
Both versions here return 0 for a sentinel query outright.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# Packed-coordinate layout (exact, collision-free for in-range bins):
#   polar:   theta[7b] << 24 | phi[6b] << 18 | r[18b]
#   uniform: (x+512)[10b] << 20 | (y+512)[10b] << 10 | (z+512)[10b]
INVALID_PACK = 0x7FFFFFFF
MAX_PLANES = 16
MAX_SHARED_KEYS = 232448 // 4  # int32 table keys in the 227 KB a block may hold
_CHUNK = 1024  # query columns per one-hot tile in the plain version


def pack_polar(coord: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 (theta, phi, r) bins -> packed int32; out-of-range
    bins map to INVALID_PACK."""
    t, p, r = coord[..., 0], coord[..., 1], coord[..., 2]
    ok = (t >= 0) & (t < 128) & (p >= 0) & (p < 64) & (r >= 0) & (r < (1 << 18))
    packed = (t << 24) | (p << 18) | r
    return torch.where(ok, packed, INVALID_PACK).to(torch.int32)


def unpack_polar(pack: torch.Tensor) -> torch.Tensor:
    return torch.stack([(pack >> 24) & 0x7F, (pack >> 18) & 0x3F, pack & 0x3FFFF], dim=-1)


def pack_uniform(coord: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 cartesian bins -> packed int32 (valid |bin| < 512)."""
    c = coord + 512
    ok = torch.all((c >= 0) & (c < 1024), dim=-1)
    packed = (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]
    return torch.where(ok, packed, INVALID_PACK).to(torch.int32)


def unpack_uniform(pack: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [((pack >> 20) & 0x3FF) - 512, ((pack >> 10) & 0x3FF) - 512, (pack & 0x3FF) - 512], dim=-1
    )


def keyed_matmul_torch(values: torch.Tensor, keys_k: torch.Tensor,
                       keys_m: torch.Tensor) -> torch.Tensor:
    """Plain version: values [B, S, K] f32, keys_k [B, K], keys_m [B, M]
    int32 -> [B, S, M] f32 as equality matmuls over chunks of M, one
    instance at a time (a batched matmul may split its work by the batch
    size, and round an instance differently in a batch than alone)."""
    outs = []
    for m0 in range(0, keys_m.shape[-1], _CHUNK):
        km = keys_m[:, m0:m0 + _CHUNK]
        eq = (keys_k[:, :, None] == km[:, None, :]) & (km != INVALID_PACK)[:, None, :]
        eq = eq.to(values.dtype)
        outs.append(torch.stack([values[i] @ eq[i] for i in range(values.shape[0])]))
    if not outs:
        return values.new_zeros(values.shape[0], values.shape[1], 0)
    return torch.cat(outs, dim=-1)


def _check(values, keys_k, keys_m):
    if values.dim() != 3 or keys_k.dim() != 2 or keys_m.dim() != 2:
        raise ValueError("keyed_matmul wants values [B, S, K], keys_k [B, K], keys_m [B, M]")
    b, s, k = values.shape
    if keys_k.shape != (b, k) or keys_m.shape[0] != b:
        raise ValueError(f"shape mismatch: values {tuple(values.shape)}, keys_k "
                         f"{tuple(keys_k.shape)}, keys_m {tuple(keys_m.shape)}")
    if values.dtype != torch.float32 or keys_k.dtype != torch.int32 or keys_m.dtype != torch.int32:
        raise TypeError("keyed_matmul wants f32 values and int32 keys")
    if not (values.device == keys_k.device == keys_m.device):
        raise ValueError("keyed_matmul operands lie on different devices")
    if s > MAX_PLANES:
        raise ValueError(f"keyed_matmul supports at most {MAX_PLANES} value planes, got {s}")


def check_join_keys(k: int) -> None:
    """A join stages one instance's K sorted keys in shared memory: at most
    MAX_SHARED_KEYS (227 KB of int32). Larger tables raise."""
    if k > MAX_SHARED_KEYS:
        raise ValueError(f"keyed_matmul: a join takes at most {MAX_SHARED_KEYS} table keys per "
                         f"instance (227 KB of shared memory), got {k}")


def _rows_layout(values: torch.Tensor) -> bool:
    """True for a row-major table seen as [B, S, K]: the S values of a
    column contiguous in 16-byte aligned rows of a multiple of 4 floats."""
    _, s, _ = values.shape
    sb, ss, sk = values.stride()
    return (ss == 1 and sk % 4 == 0 and sk >= (s + 3) // 4 * 4 and sb % 4 == 0
            and values.data_ptr() % 16 == 0)


def keyed_matmul(values: torch.Tensor, keys_k: torch.Tensor, keys_m: torch.Tensor,
                 keys_sorted: bool = False, run_heads: bool = False) -> torch.Tensor:
    """out[b, s, m] = sum over k of values[b, s, k] where keys_k[b, k] ==
    keys_m[b, m]; values [B, S, K] f32 (any strides), keys int32, S <= 16.

    keys_sorted=True promises each row of keys_k ascending (a voxel table);
    otherwise the keys and value columns are first put in order with a
    stable sort. With sorted keys and keys_m the very same tensor as keys_k
    (a voxel build over its own sorted packs), each run is summed once and
    written to all its slots. run_heads=True (with keys_sorted) promises
    that only the first slot of each run of equal keys_k holds non-zero
    values, as in a voxel table; a join then reads that slot alone. CPU
    tensors take the plain version; CUDA tensors launch a kernel, counted
    in `keyed_matmul.launches`."""
    _check(values, keys_k, keys_m)
    if values.device.type == "cpu":
        return keyed_matmul_torch(values, keys_k, keys_m)
    if values.device.type != "cuda":
        raise ValueError(f"keyed_matmul: unsupported device {values.device}")
    if not (keys_k.is_contiguous() and keys_m.is_contiguous()):
        raise ValueError("keyed_matmul wants contiguous keys")
    b, s, k = values.shape
    m = keys_m.shape[1]
    out = torch.empty((b, s, m), dtype=torch.float32, device=values.device)
    if b == 0 or m == 0:
        return out
    runs = keys_sorted and keys_m.data_ptr() == keys_k.data_ptr() and keys_m.shape == keys_k.shape
    if not runs:
        check_join_keys(k)
    if not keys_sorted:
        keys_k, order = torch.sort(keys_k, dim=-1, stable=True)
        values = torch.gather(values, 2, order[:, None, :].expand(b, s, k))
    stream = torch.cuda.current_stream(values.device).cuda_stream
    strides = values.stride()
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if runs:
        partial = torch.empty_like(out)
        fn = cuda_build.function("keyed_sum", "rolo_keyed_sum_runs",
                                 [p] + [ll] * 3 + [p] * 3 + [i] * 3 + [p])
        rc = fn(values.data_ptr(), *strides, keys_k.data_ptr(), partial.data_ptr(),
                out.data_ptr(), b, s, k, stream)
    else:
        fn = cuda_build.function("keyed_sum", "rolo_keyed_sum",
                                 [p] + [ll] * 3 + [i] * 2 + [p] * 3 + [i] * 4 + [p])
        rc = fn(values.data_ptr(), *strides, int(_rows_layout(values)),
                int(keys_sorted and run_heads), keys_k.data_ptr(), keys_m.data_ptr(),
                out.data_ptr(), b, s, k, m, stream)
    cuda_build.check_launch(rc, "keyed_sum")
    keyed_matmul.launches += 1
    return out


keyed_matmul.launches = 0

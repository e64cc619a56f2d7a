// k-NN neighbourhood moments: for each query q, the sum of the candidate
// moment planes xc[:, j] over the candidates j whose squared distance is at
// most the k-th-neighbour radius of the reference's bisection.
//
// Replaces the TPU kernel `_moments_kernel` launched by `knn_moments`
// (rolo_tpu/ops/knn_moments.py:66-192) with the same contract:
//   - d2 in the elementwise difference form (the |c|^2 - 2c.q + |q|^2 form
//     cancels at lidar range), rounded as the reference rounds it: no FMA
//     contraction, so the membership agrees bit for bit with the plain
//     torch versions;
//   - upper bound hi0 = sqrt(max valid d2) + 1, then `iters` bisection
//     steps lo/hi on the radius, membership d2 <= hi^2 (all ties in);
//   - invalid candidates take no part in the max or the membership, so a
//     starved query (< k valid candidates) takes every valid candidate;
//   - f32 sums of the S <= 16 moment planes; masked queries are written 0.
//
// Bound on the H100: f32 instruction throughput of the distance work, one
// distance (3 sub, 3 mul, 2 add: 8 FLOP, no FMA) per valid (query,
// candidate) pair. At B = 16 and Q = N = 8192 that is 8.6 GFLOP, 0.128 ms at
// the card's 67 TFLOP/s (0.057 ms for the ~5,900 valid points of the
// bench's feature clouds); the ~14 MB of operands are 4 us of memory time.
//
// What the design does about it. The reference's bisection counts every
// candidate at each of its 18 steps. One step tests cnt(mid) < k with
// cnt(mid) = #{valid j : d2_j <= fl(mid * mid)}, which holds exactly when
// d2_(k), the k-th smallest valid d2 counted with multiplicity (+inf when
// fewer than k are valid), exceeds fl(mid * mid). So:
//   1. Select: one sweep keeps, per query, the running max of d2 (for hi0)
//      and the k smallest d2 in a sorted register queue of KQ slots (the
//      least of 8, 16, 24, 32 that holds k). The KQ - k lowest slots hold
//      -inf, so the k-th smallest always sits in the top slot and every
//      index is static (no local memory). A candidate at or above the top
//      slot changes nothing and is rejected by one compare; most are.
//   2. Replay the 18 bisection steps in registers from d2_(k) and hi0, with
//      the same __fmul_rn / __fadd_rn sequence: the same hi, bit for bit.
//   3. Sum: a second sweep adds the moment planes of the members.
// An insert costs ~2 KQ instructions against ~13 for a rejected candidate,
// and a warp pays for any lane's insert. The wrapper therefore hands the
// points over in a spatial (Morton) order, made by two small kernels here
// and one torch.sort: a warp's 32 queries are neighbours, and each query
// group starts its sweeps at its own place among the sorted candidates, so
// the queue bound is tight after the first tiles and later inserts are
// rare (the feature clouds come in hash order, where a warp's lanes insert
// at unrelated candidates). In that order a tile of 64 candidates is
// compact, and its bounding box gives each query a lower and an upper
// bound on the tile's d2, rounded as dist2 rounds, so exact: sweep 1 skips
// a tile that can neither enter a queue nor raise a max, sweep 2 a tile
// with no member; most tiles are skipped.
// The candidates stream through shared memory in (x, y, z, valid) float4
// tiles, double-buffered with cp.async, one tile ring per warp; invalid
// slots carry NaN coordinates, so no mask test sits in the inner loop (NaN
// compares false and fmaxf ignores it). Masked queries take NaN coordinates
// the same way and sort last, so their warps do no work.
// The P warps of a query group each sweep an interleaved 1/P of the tiles
// (P from 1 to 8, by the batch). Their queues merge in shared memory (a
// tree of two-list merges) into the exact d2_(k); while selecting, the
// slices share the smallest top slot as a common rejection bound (any
// slice's k-th smallest bounds the global one from above, so the merge
// stays exact) and the largest max. The P partial plane sums are added in
// slice order, with no atomics: a run gives the same bits every time. A
// group synchronises on its own named barrier, never on other groups. No
// tensor cores: the distances must round as the reference's do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kMaxK = 32;    // queue slots; the wrapper refuses k > kMaxK
constexpr int kWarps = 8;    // warps per block: kWarps / P query groups x P slices
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;    // candidates per warp tile (2 per lane); TILE in the wrapper
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Smem {
  float4 tile[kWarps][2][kTile];   // each warp's double-buffered candidate tiles
  float list[kWarps][kMaxK][32];   // queues to merge; later the partial plane sums
  float rmax[kWarps][32];
  int bound[kWarps][32];           // per query group: the shared rejection bound (f32 bits)
  int reach[kWarps][32];           // per query group: the largest d2 any slice has seen (bits)
  float r2[kWarps][32];            // per query group: the replayed hi^2
};
static_assert(kMaxPlanes <= kMaxK, "the plane sums reuse the merge lists");

__device__ __forceinline__ float dist2(const float4 c, float qx, float qy, float qz) {
  const float dx = __fsub_rn(c.x, qx);
  const float dy = __fsub_rn(c.y, qy);
  const float dz = __fsub_rn(c.z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Sorted (ascending) queue insert of d, dropping the largest slot:
// new[i] = min(q[i], max(d, q[i-1])), evaluated from the top down.
template <int KQ>
__device__ __forceinline__ void insert(float (&q)[KQ], float d) {
#pragma unroll
  for (int i = KQ - 1; i > 0; --i) q[i] = fminf(q[i], fmaxf(d, q[i - 1]));
  q[0] = fminf(q[0], d);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Stage candidates [t0, t0 + kTile) of one instance into a warp's tile; past
// N the slots are invalid (NaN coordinates, valid 0). One commit group.
__device__ __forceinline__ void stage(float4* dst, const float4* cand, int t0, int N, int lane) {
#pragma unroll
  for (int i = lane; i < kTile; i += 32) {
    const int j = t0 + i;
    if (j < N) cp_async16(dst + i, cand + j);
    else dst[i] = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  }
  cp_async_commit();
}

// Barrier of one query group's P warps (named barrier g + 1; barrier 0 is
// __syncthreads): groups never wait on each other.
__device__ __forceinline__ void group_sync(int g, int P) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(32 * P) : "memory");
}

// Lower and upper bounds of d2 from the query to any candidate of a tile's
// box, rounded like dist2: correctly rounded operations are monotone, so
// near2 <= dist2(c) <= far2 for every candidate c of the tile, bit for bit.
__device__ __forceinline__ float near2(const float4 lo, const float4 hi, float qx, float qy,
                                       float qz) {
  const float dx = fmaxf(0.f, fmaxf(__fsub_rn(lo.x, qx), __fsub_rn(qx, hi.x)));
  const float dy = fmaxf(0.f, fmaxf(__fsub_rn(lo.y, qy), __fsub_rn(qy, hi.y)));
  const float dz = fmaxf(0.f, fmaxf(__fsub_rn(lo.z, qz), __fsub_rn(qz, hi.z)));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}
__device__ __forceinline__ float far2(const float4 lo, const float4 hi, float qx, float qy,
                                      float qz) {
  const float dx = fmaxf(fabsf(__fsub_rn(lo.x, qx)), fabsf(__fsub_rn(hi.x, qx)));
  const float dy = fmaxf(fabsf(__fsub_rn(lo.y, qy)), fabsf(__fsub_rn(hi.y, qy)));
  const float dz = fmaxf(fabsf(__fsub_rn(lo.z, qz)), fabsf(__fsub_rn(hi.z, qz)));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Streams the tiles of this warp's slice, t = t0 + p, t0 + p + P, ...
// (mod ntiles), that need(t) asks for (a warp-uniform answer from the
// tile's box), and calls body(tile, t) on each. The next tile is chosen and
// staged while the current one is processed; need() then sees the bounds
// of one tile back, which can only ask for more tiles, never fewer.
template <typename Need, typename Body>
__device__ __forceinline__ void sweep(float4 (&tiles)[2][kTile], const float4* cand, int N, int p,
                                      int P, int t0, int lane, Need need, Body body) {
  const int ntiles = (N + kTile - 1) / kTile;
  auto tile_of = [&](int u) { return u + t0 < ntiles ? u + t0 : u + t0 - ntiles; };
  auto next = [&](int u) {
    while (u < ntiles && !need(tile_of(u))) u += P;
    return u;
  };
  int u = next(p);
  if (u >= ntiles) return;
  stage(tiles[0], cand, tile_of(u) * kTile, N, lane);
  int buf = 0;
  while (u < ntiles) {
    const int un = next(u + P);
    if (un < ntiles) stage(tiles[buf ^ 1], cand, tile_of(un) * kTile, N, lane);
    else cp_async_commit();  // an empty group keeps wait_group 1 exact
    cp_async_wait_prev();
    __syncwarp();
    body(tiles[buf], tile_of(u));
    __syncwarp();  // the tile is restaged two steps on
    buf ^= 1;
    u = un;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// KQ: the queue's slots, the least of 8, 16, 24, 32 that holds k.
template <int KQ>
__global__ void __launch_bounds__(kThreads, 3)
knn_moments_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ qmask,
                   const int32_t* __restrict__ qperm, const int32_t* __restrict__ qstart,
                   const float4* __restrict__ cand, const float4* __restrict__ boxes,
                   const float* __restrict__ xc, float* __restrict__ out, int Q, int N, int S,
                   int k, int iters, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = w / P;  // query group within the block
  const int p = w % P;  // candidate slice
  const int groups = kWarps / P;
  const int b = blockIdx.y;
  const int slot = (blockIdx.x * groups + g) * 32 + lane;  // position in spatial order
  const int q = slot < Q ? qperm[(size_t)b * Q + slot] : Q;
  const float4* cb = cand + (size_t)b * N;
  const float* xb = xc + (size_t)b * S * N;

  const bool live = q < Q && qmask[(size_t)b * Q + q] != 0;
  float qx = CUDART_NAN_F, qy = CUDART_NAN_F, qz = CUDART_NAN_F;
  if (live) {
    const float* v = xyz + ((size_t)b * Q + q) * 3;
    qx = v[0]; qy = v[1]; qz = v[2];
  }
  const bool group_live = __any_sync(kFull, live);  // the same in the group's P warps
  // the group's sweeps start at the tile of its first query's place among
  // the spatially sorted candidates, and wrap around
  int start = slot < Q ? (qstart ? qstart[(size_t)b * Q + slot] : slot) : 0;
  start = __shfl_sync(kFull, start, 0);
  const int ntiles = (N + kTile - 1) / kTile;
  const int t0 = ntiles ? min(start / kTile, ntiles - 1) : 0;
  const float4* bb = boxes + (size_t)b * ntiles * 2;  // per tile: (lo, valid count), (hi, 0)

  if (p == 0) {
    sm.bound[g][lane] = __float_as_int(CUDART_INF_F);
    sm.reach[g][lane] = __float_as_int(0.f);
  }
  group_sync(g, P);

  // Sweep 1: the running max and the k smallest d2 of this slice.
  float queue[KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) queue[i] = i < KQ - k ? -CUDART_INF_F : CUDART_INF_F;
  float rmax = 0.f;
  if (group_live) {
    // a tile is needed while a lane's queue could take one of its
    // candidates or a lane's running max could grow
    auto need = [&](int t) {
      const float4 lo = bb[2 * t], hi = bb[2 * t + 1];
      if (lo.w == 0.f) return false;
      const float bound = fminf(queue[KQ - 1], __int_as_float(*(volatile int*)&sm.bound[g][lane]));
      const float reach = fmaxf(rmax, __int_as_float(*(volatile int*)&sm.reach[g][lane]));
      return __any_sync(kFull, (near2(lo, hi, qx, qy, qz) < bound) |
                                   (far2(lo, hi, qx, qy, qz) > reach)) != 0;
    };
    sweep(sm.tile[w], cb, N, p, P, t0, lane, need, [&](const float4* tile, int) {
      float bound = fminf(queue[KQ - 1],
                          __int_as_float(*(volatile int*)&sm.bound[g][lane]));
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        const float d = dist2(tile[j], qx, qy, qz);
        rmax = fmaxf(rmax, d);
        if (d < bound) {
          insert(queue, d);
          bound = fminf(bound, queue[KQ - 1]);
        }
      }
      if (P > 1) {
        atomicMin(&sm.bound[g][lane], __float_as_int(queue[KQ - 1]));
        atomicMax(&sm.reach[g][lane], __float_as_int(rmax));
      }
    });
  }
#pragma unroll
  for (int i = 0; i < KQ; ++i)
    if (i >= KQ - k) sm.list[w][i - (KQ - k)][lane] = queue[i];
  sm.rmax[w][lane] = rmax;
  group_sync(g, P);

  // Merge the P sorted lists of k values pairwise: list p absorbs p + h.
  for (int h = 1; h < P; h <<= 1) {
    if ((p & (2 * h - 1)) == 0) {
      float(*a)[32] = sm.list[w];
      float(*c)[32] = sm.list[w + h];
      float merged[KQ];
      int i = 0, j = 0;
#pragma unroll
      for (int t = 0; t < KQ; ++t) {
        if (t < k) {
          const float x = a[i][lane], y = c[j][lane];
          const bool take_a = x <= y;
          merged[t] = take_a ? x : y;
          i += take_a;
          j += !take_a;
        }
      }
#pragma unroll
      for (int t = 0; t < KQ; ++t)
        if (t < k) a[t][lane] = merged[t];
    }
    group_sync(g, P);
  }

  // Replay the bisection from d2_(k) and hi0.
  if (p == 0) {
    const float kth = sm.list[w][k - 1][lane];
    float m = 0.f;
    for (int i = 0; i < P; ++i) m = fmaxf(m, sm.rmax[g * P + i][lane]);
    float lo = 0.f;
    float hi = __fadd_rn(__fsqrt_rn(m), 1.f);
    for (int it = 0; it < iters; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      if (kth > __fmul_rn(mid, mid)) lo = mid; else hi = mid;
    }
    sm.r2[g][lane] = __fmul_rn(hi, hi);
  }
  group_sync(g, P);

  // Sweep 2: this slice's plane sums over the members.
  const float r2 = sm.r2[g][lane];
  float acc[kMaxPlanes];
#pragma unroll
  for (int s = 0; s < kMaxPlanes; ++s) acc[s] = 0.f;
  if (group_live) {
    auto need = [&](int t) {  // a tile with a member for some lane
      const float4 lo = bb[2 * t], hi = bb[2 * t + 1];
      return lo.w != 0.f && __any_sync(kFull, near2(lo, hi, qx, qy, qz) <= r2) != 0;
    };
    sweep(sm.tile[w], cb, N, p, P, t0, lane, need, [&](const float4* tile, int t) {
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        if (dist2(tile[j], qx, qy, qz) <= r2) {
          const float* col = xb + t * kTile + j;
#pragma unroll
          for (int s = 0; s < kMaxPlanes; ++s)
            if (s < S) acc[s] = __fadd_rn(acc[s], __ldg(col + (size_t)s * N));
        }
      }
    });
  }
#pragma unroll
  for (int s = 0; s < kMaxPlanes; ++s) sm.list[w][s][lane] = acc[s];
  group_sync(g, P);

  // The P partial sums in slice order; masked queries get 0.
  if (p == 0 && q < Q) {
    float* ob = out + (size_t)b * S * Q + q;
#pragma unroll
    for (int s = 0; s < kMaxPlanes; ++s) {
      if (s < S) {
        float total = 0.f;
        for (int i = 0; i < P; ++i) total = __fadd_rn(total, sm.list[g * P + i][s][lane]);
        ob[(size_t)s * Q] = live ? total : 0.f;
      }
    }
  }
}

// Bit i of v (10 bits) moved to bit 3 i.
__device__ __forceinline__ uint32_t spread3(uint32_t v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// 30-bit Morton codes of cells of `cell` metres, 10 bits a coordinate
// around the origin; masked points get INT32_MAX, after every valid code.
__global__ void morton_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                              int32_t* __restrict__ code, int n, float inv_cell) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t c = 0x7FFFFFFFu;
  if (mask[i]) {
    c = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float f = floorf(xyz[3 * (size_t)i + d] * inv_cell) + 512.f;
      c |= spread3((uint32_t)fminf(fmaxf(f, 0.f), 1023.f)) << d;
    }
  }
  code[i] = (int32_t)c;
}

// The candidates in the sorted order as (x, y, z, 1) float4, (nan, nan,
// nan, 0) where masked, their moment planes xc [B, S, n] in the same order,
// and their original indices as int32.
__global__ void gather_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                              const float* __restrict__ xc, const long long* __restrict__ order,
                              float4* __restrict__ cand, float* __restrict__ xcs,
                              int32_t* __restrict__ cperm, int n, int S) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int i = (int)order[(size_t)b * n + j];
  const size_t src = (size_t)b * n + i;
  float4 c = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  if (mask[src]) c = make_float4(xyz[3 * src], xyz[3 * src + 1], xyz[3 * src + 2], 1.f);
  cand[(size_t)b * n + j] = c;
  cperm[(size_t)b * n + j] = i;
  for (int p = 0; p < S; ++p) xcs[((size_t)b * S + p) * n + j] = xc[((size_t)b * S + p) * n + i];
}

// Per tile of kTile sorted candidates: its bounding box of the valid ones,
// box[2 t] = (lo, valid count), box[2 t + 1] = (hi, 0).
__global__ void __launch_bounds__(kTile)
box_kernel(const float4* __restrict__ cand, float4* __restrict__ box, int N) {
  __shared__ float4 part[kTile / 32][2];
  const int b = blockIdx.y, t = blockIdx.x, ntiles = gridDim.x;
  const int j = t * kTile + threadIdx.x;
  const float4 c = j < N ? cand[(size_t)b * N + j] : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool valid = c.w != 0.f;
  float4 lo = valid ? make_float4(c.x, c.y, c.z, 1.f)
                    : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
  float4 hi = valid ? c : make_float4(-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(kFull, lo.x, o));
    lo.y = fminf(lo.y, __shfl_xor_sync(kFull, lo.y, o));
    lo.z = fminf(lo.z, __shfl_xor_sync(kFull, lo.z, o));
    lo.w += __shfl_xor_sync(kFull, lo.w, o);
    hi.x = fmaxf(hi.x, __shfl_xor_sync(kFull, hi.x, o));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(kFull, hi.y, o));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(kFull, hi.z, o));
  }
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = lo;
    part[threadIdx.x >> 5][1] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kTile / 32; ++i) {
      const float4 l = part[i][0], h = part[i][1];
      lo = make_float4(fminf(lo.x, l.x), fminf(lo.y, l.y), fminf(lo.z, l.z), lo.w + l.w);
      hi = make_float4(fmaxf(hi.x, h.x), fmaxf(hi.y, h.y), fmaxf(hi.z, h.z), 0.f);
    }
    box[((size_t)b * ntiles + t) * 2] = lo;
    box[((size_t)b * ntiles + t) * 2 + 1] = make_float4(hi.x, hi.y, hi.z, 0.f);
  }
}

// Slices per query group: the fewest (a power of two up to kWarps) that
// give one instance about 64 warps for each of the 132 SMs. A group's
// sweeps are latency-bound chains, and dense groups take the longest, so
// slices pay even where the query groups alone would fill the card. The
// count follows the instance, not the batch: the slices' partial sums merge
// in a fixed order, so a query gets the same bits in a batch of any size.
int slices(int Q) {
  const long long warps = (Q + 31) / 32;
  int P = 1;
  while (P < kWarps && warps * P < 132LL * 64) P <<= 1;
  return P;
}

template <int KQ, typename... Args>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream, Args... args) {
  static bool configured = false;  // dynamic shared memory above 48 KB, once
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        knn_moments_kernel<KQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    configured = true;
  }
  knn_moments_kernel<KQ><<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// code [n] int32 from xyz [n, 3] f32 and mask [n] u8 (n points of any
// batch, flattened).
extern "C" int rolo_morton_codes(const float* xyz, const uint8_t* mask, int32_t* code, int n,
                                 float cell, cudaStream_t stream) {
  if (n <= 0 || !(cell > 0.f)) return (int)cudaErrorInvalidValue;
  morton_kernel<<<(n + 255) / 256, 256, 0, stream>>>(xyz, mask, code, n, 1.f / cell);
  return (int)cudaGetLastError();
}

// cand [B, N] float4, xcs [B, S, N] and cperm [B, N] int32 from xyz
// [B, N, 3], mask [B, N], xc [B, S, N] and the sorting permutation order
// [B, N] int64; box [B, ntiles, 2] float4, the tiles' bounding boxes.
extern "C" int rolo_knn_moments_gather(const float* xyz, const uint8_t* mask, const float* xc,
                                       const long long* order, float4* cand, float* xcs,
                                       int32_t* cperm, float4* box, int B, int N, int S,
                                       cudaStream_t stream) {
  if (B <= 0 || N <= 0 || S <= 0 || S > kMaxPlanes) return (int)cudaErrorInvalidValue;
  gather_kernel<<<dim3((N + 255) / 256, B), 256, 0, stream>>>(xyz, mask, xc, order, cand, xcs,
                                                              cperm, N, S);
  box_kernel<<<dim3((N + kTile - 1) / kTile, B), kTile, 0, stream>>>(cand, box, N);
  return (int)cudaGetLastError();
}

// xyz [B, Q, 3] f32, qmask [B, Q] u8, xc [B, S, N] f32 -> out [B, S, Q].
// The points come in a spatial order: qperm [B, Q] lists the queries in it;
// cand [B, N] float4 (x, y, z, valid), NaN coordinates at invalid slots,
// holds the candidates in it and xc [B, S, N] their moment planes;
// qstart [B, Q] is each sorted query's place among the sorted candidates
// (null: the queries are the candidates, in the same order).
extern "C" int rolo_knn_moments(const float* xyz, const uint8_t* qmask, const int32_t* qperm,
                                const int32_t* qstart, const float4* cand, const float4* boxes,
                                const float* xc, float* out, int B, int Q, int N, int S, int k,
                                int iters, cudaStream_t stream) {
  if (B <= 0 || Q <= 0 || N < 0 || S <= 0 || S > kMaxPlanes || k < 1 || k > kMaxK || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  const int P = slices(Q);
  const int groups = kWarps / P;
  const int qwarps = (Q + 31) / 32;
  const dim3 grid((qwarps + groups - 1) / groups, B);
  auto go = [&](auto kq) {
    return launch<decltype(kq)::value>(grid, smem, stream, xyz, qmask, qperm, qstart, cand,
                                       boxes, xc, out, Q, N, S, k, iters, P);
  };
  const cudaError_t rc = k <= 8    ? go(std::integral_constant<int, 8>())
                         : k <= 16 ? go(std::integral_constant<int, 16>())
                         : k <= 24 ? go(std::integral_constant<int, 24>())
                                   : go(std::integral_constant<int, 32>());
  return (int)rc;
}

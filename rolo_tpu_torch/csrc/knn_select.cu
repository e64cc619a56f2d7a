// Exact k-nearest-neighbour selection in the matmul distance form: for each
// query q of each instance, the k indices j of the smallest
//   d_j = (qq - 2 dot(q, x_j)) + xx_j,
// nearest first, ties to the lower index. qq = |q|^2 and xx_j = |x_j|^2
// (+inf at invalid points) come from the wrapper, computed by the same torch
// ops as the plain version's tile, so d is the plain tile's value bit for bit.
//
// Replaces no TPU kernel: the JAX package leaves this selection to XLA (a
// [chunk, N] distance tile and `jax.lax.top_k`, rolo_tpu/voxel/knn.py:45-121),
// and the port's plain version (voxel/knn.py) does the same in torch: per
// 512-query chunk a [B, 512, N] f32 tile from B K = 3 cuBLAS products, four
// elementwise passes over it, then torch.topk's multi-pass radix select. At
// the mapping binds' shapes (B = 16, 16,384 queries against 32,768 submap
// slots a round) that is ~480 GB of device traffic a round.
//
// Bound on the H100: f32 instruction throughput, ~6 instructions a (query,
// point) pair: 3 for the dot, 1 FMA for qq - 2 dot, 1 add, 1 compare. A round
// of the batch's binds is 8.6e9 pairs, ~1.5 ms at 132 SMs x 128 lanes x
// 1.98 GHz; operands and output are a few MB.
//
// What the design does about it:
//   - one CTA of 256 threads serves one instance's queries; warp w takes
//     query group w / P (32 queries, one a lane) and point slice w % P, with
//     P from 1 to 8 chosen so that the grid fills the card;
//   - the instance's points stream through shared memory as (x, y, z, xx)
//     float4 tiles of kTile points, double-buffered with cp.async; the 32
//     lanes of a warp read the same point (a broadcast), and slice p takes
//     the p-th contiguous part of every tile, so each thread meets its points
//     in increasing index order;
//   - each thread keeps its slice's KQ best (d, j) sorted in registers (KQ
//     the least of 1, 5, 8, 16, 32, 64 that holds k: the binds' 5, the
//     ICPs' 1, the candidate search's scan2map_candidates; the KQ - k
//     lowest slots hold (-inf, -1), so the k-th best is always the top slot
//     and every register index is static). A point that does not beat the
//     top slot is rejected by one compare; most are. At KQ = 64 the queue
//     takes 128 registers a thread and its merge lists 128 KB of shared
//     memory;
//   - the order is (d, j) lexicographic. Within a thread j only grows, so a
//     strict d < top keeps the lower index on ties; the slices' lists merge
//     in shared memory under the same order, so the result is the exact
//     top-k of that order whatever P is: a batch gives each instance the
//     bits it gets alone, and a run the same bits every time (no atomics);
//   - until a thread has seen KQ points its top slot is (+inf, INT_MAX),
//     which any point with d <= +inf beats: where fewer than k points are
//     valid, the tail takes the lowest-index invalid slots (d = +inf). A
//     NaN d (a NaN query, an invalid one) never enters; a slot left empty
//     is written as index 0;
//   - nothing is written but the [B, Q, k] int64 indices.
// No tensor cores: the distances must round as the plain tile rounds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;                  // warps a CTA: kWarps / P query groups x P slices
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;                // points a shared-memory tile
constexpr int kMaxK = 64;                  // MAX_K in the wrapper
constexpr int kMaxDevices = 64;            // device ordinals whose launch limit is raised
constexpr int kEmpty = 0x7FFFFFFF;         // index of a slot no point has filled
constexpr int kTileBytes = 2 * kTile * 16;  // the double-buffered float4 tiles

// dot(q, x) rounded as the plain tile's K = 3 cuBLAS product rounds it: an
// FMA chain over the coordinates in order, starting from a rounded product
// (on the H100 the chain from z down, or no FMA, differs in every row).
__device__ __forceinline__ float dot3(float qx, float qy, float qz, const float4 c) {
  return __fmaf_rn(qz, c.z, __fmaf_rn(qy, c.y, __fmul_rn(qx, c.x)));
}

// (qq - 2 dot) + xx: 2 dot is exact, so the FMA rounds as the tile's
// subtraction of the doubled product.
__device__ __forceinline__ float dist(float qx, float qy, float qz, float qq, const float4 c) {
  return __fadd_rn(__fmaf_rn(-2.f, dot3(qx, qy, qz, c), qq), c.w);
}

__device__ __forceinline__ bool less(float d, int j, float e, int i) {
  return d < e || (d == e && j < i);
}

// Sorted insert of (d, j), which is less than the top slot, dropping the top
// slot; evaluated from the top down so each step reads the old slot below.
template <int KQ>
__device__ __forceinline__ void insert(float (&qd)[KQ], int (&qi)[KQ], float d, int j) {
#pragma unroll
  for (int i = KQ - 1; i > 0; --i) {
    const bool below = less(d, j, qd[i - 1], qi[i - 1]);
    const bool here = less(d, j, qd[i], qi[i]);
    qd[i] = below ? qd[i - 1] : (here ? d : qd[i]);
    qi[i] = below ? qi[i - 1] : (here ? j : qi[i]);
  }
  if (less(d, j, qd[0], qi[0])) {
    qd[0] = d;
    qi[0] = j;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Stage points [t0, t0 + kTile) of one instance into a tile, one commit
// group; past N the slots hold xx = NaN, so their d is NaN and never enters.
__device__ __forceinline__ void stage(float4* dst, const float4* pts, int t0, int N) {
#pragma unroll
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (t0 + i < N) cp_async16(dst + i, pts + t0 + i);
    else dst[i] = make_float4(0.f, 0.f, 0.f, CUDART_NAN_F);
  }
  cp_async_commit();
}

template <int KQ>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ q, const float* __restrict__ qq,
                  const float4* __restrict__ pts, long long* __restrict__ out, int Q, int N,
                  int k, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4(*tiles)[kTile] = reinterpret_cast<float4(*)[kTile]>(smem_raw);
  // after the sweep, the slices' lists [KQ][kThreads] of d, then of j
  float* list_d = reinterpret_cast<float*>(smem_raw);
  int* list_i = reinterpret_cast<int*>(smem_raw) + KQ * kThreads;

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = w % P;
  const int groups = kWarps / P;
  const int b = blockIdx.y;
  const int qi = (blockIdx.x * groups + w / P) * 32 + lane;
  const float4* pb = pts + (size_t)b * N;

  float qx = CUDART_NAN_F, qy = CUDART_NAN_F, qz = CUDART_NAN_F, q2 = CUDART_NAN_F;
  if (qi < Q) {
    const float* v = q + ((size_t)b * Q + qi) * 3;
    qx = v[0];
    qy = v[1];
    qz = v[2];
    q2 = qq[(size_t)b * Q + qi];
  }
  float qd[KQ];
  int qj[KQ];
#pragma unroll
  for (int i = 0; i < KQ; ++i) {
    qd[i] = i < KQ - k ? -CUDART_INF_F : CUDART_INF_F;
    qj[i] = i < KQ - k ? -1 : kEmpty;
  }

  const int span = kTile / P;  // this slice's points of a tile
  const int ntiles = (N + kTile - 1) / kTile;
  stage(tiles[0], pb, 0, N);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) stage(tiles[(t + 1) & 1], pb, (t + 1) * kTile, N);
    else cp_async_commit();  // an empty group keeps wait_group 1 exact
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* tile = tiles[t & 1] + p * span;
    const int j0 = t * kTile + p * span;
#pragma unroll 8
    for (int i = 0; i < span; ++i) {
      const float d = dist(qx, qy, qz, q2, tile[i]);
      if (d <= qd[KQ - 1] && less(d, j0 + i, qd[KQ - 1], qj[KQ - 1])) insert(qd, qj, d, j0 + i);
    }
    __syncthreads();  // the tile is restaged on the next step
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // Merge: slice 0 of each query takes the other slices' sorted lists.
  if (P > 1) {
    if (p > 0) {
#pragma unroll
      for (int i = 0; i < KQ; ++i) {
        list_d[i * kThreads + threadIdx.x] = qd[i];
        list_i[i * kThreads + threadIdx.x] = qj[i];
      }
    }
    __syncthreads();
    if (p == 0) {
      for (int s = 1; s < P; ++s) {
        const int src = threadIdx.x + s * 32;
        for (int i = KQ - k; i < KQ; ++i) {
          const float d = list_d[i * kThreads + src];
          const int j = list_i[i * kThreads + src];
          if (!less(d, j, qd[KQ - 1], qj[KQ - 1])) break;  // the rest of the list is larger
          insert(qd, qj, d, j);
        }
      }
    }
  }
  if (p == 0 && qi < Q) {
    long long* o = out + ((size_t)b * Q + qi) * k;
#pragma unroll
    for (int i = 0; i < KQ; ++i)
      if (i >= KQ - k) o[i - (KQ - k)] = qj[i] == kEmpty ? 0 : qj[i];
  }
}

// Slices per query group: the fewest (a power of two up to kWarps) that put
// about 32 warps on each of the 132 SMs. The result does not depend on it.
int slices(long long qwarps) {
  int P = 1;
  while (P < kWarps && qwarps * P < 132LL * 32) P <<= 1;
  return P;
}

template <int KQ>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* q, const float* qq,
                   const float4* pts, long long* out, int Q, int N, int k, int P) {
  constexpr int lists = 2 * KQ * kThreads * 4;
  constexpr int smem = lists > kTileBytes ? lists : kTileBytes;
  // dynamic shared memory above 48 KB is a per-device attribute: raised
  // once on each device (no API call that could break a stream capture)
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return rc;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    rc = cudaFuncSetAttribute(knn_select_kernel<KQ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    configured[device] = true;
  }
  knn_select_kernel<KQ><<<grid, kThreads, smem, stream>>>(q, qq, pts, out, Q, N, k, P);
  return cudaGetLastError();
}

}  // namespace

// q [B, Q, 3] f32, qq [B, Q] f32, pts [B, N] float4 (x, y, z, xx; xx = +inf
// at invalid points, their coordinates zero) -> out [B, Q, k] int64, the k
// nearest of each query, nearest first, ties to the lower index.
extern "C" int rolo_knn_select(const float* q, const float* qq, const float4* pts,
                               long long* out, int B, int Q, int N, int k,
                               cudaStream_t stream) {
  if (B <= 0 || Q <= 0 || N < k || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const long long qwarps = (long long)B * ((Q + 31) / 32);
  const int P = slices(qwarps);
  const int groups = kWarps / P;
  const dim3 grid(((Q + 31) / 32 + groups - 1) / groups, B);
  auto go = [&](auto kq) {
    return launch<decltype(kq)::value>(grid, stream, q, qq, pts, out, Q, N, k, P);
  };
  const cudaError_t rc = k == 1    ? go(std::integral_constant<int, 1>())
                         : k <= 5  ? go(std::integral_constant<int, 5>())
                         : k <= 8  ? go(std::integral_constant<int, 8>())
                         : k <= 16 ? go(std::integral_constant<int, 16>())
                         : k <= 32 ? go(std::integral_constant<int, 32>())
                                   : go(std::integral_constant<int, 64>());
  return (int)rc;
}

// Keyed sum: out[b, s, m] = sum over k of values[b, s, k] where
// keys_k[b, k] == keys_m[b, m], for keys_k sorted ascending.
//
// Replaces the TPU kernel `_keyed_kernel` launched by `_keyed_matmul_pallas`
// (rolo_tpu/ops/voxel_join.py:96-167). There the sum is a one-hot matrix
// product on the MXU, because gathers and scatters serialize on a TPU.
// Hopper gathers well, so this kernel computes the function directly: one
// thread per output column binary-searches the run [lo, hi) of its key in
// the sorted keys and sums the value columns of that run in f32.
//
// Bounds on the H100: memory latency, not arithmetic. A join reads one
// S-plane column per query (each key has one valid slot), a build reads
// each run once per slot of the run. The binary search costs log2(K) ~ 13
// dependent loads of keys that stay in L1/L2 (32 KB per instance). What the
// design does about it: no one-hot matrix at all (the TPU form does
// 2*S*K*M flops), sums in full f32 with no bf16 split, and per-thread
// accumulators in registers.
//
// Contract (the wrapper checks shapes, types, devices and contiguity):
//   values [B, S, K] f32, keys_k [B, K] i32 sorted ascending per row,
//   keys_m [B, M] i32, out [B, S, M] f32, S <= 16.
//   A query equal to INVALID_PACK (0x7FFFFFFF) returns 0: callers give
//   sentinel slots zero values, so the TPU form adds nothing there either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kInvalidPack = 0x7FFFFFFF;
constexpr int kThreads = 256;

__global__ void keyed_sum_kernel(const float* __restrict__ values,
                                 const int32_t* __restrict__ keys_k,
                                 const int32_t* __restrict__ keys_m,
                                 float* __restrict__ out, int S, int K, int M) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int32_t* kk = keys_k + (size_t)b * K;
  const float* vb = values + (size_t)b * S * K;
  const int32_t key = keys_m[(size_t)b * M + m];

  float acc[kMaxPlanes];
#pragma unroll
  for (int s = 0; s < kMaxPlanes; ++s) acc[s] = 0.f;

  if (key != kInvalidPack) {
    int lo = 0, hi = K;  // lower bound: first kk >= key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kk[mid] < key) lo = mid + 1; else hi = mid;
    }
    const int start = lo;
    hi = K;  // upper bound: first kk > key
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kk[mid] <= key) lo = mid + 1; else hi = mid;
    }
    for (int k = start; k < lo; ++k) {
#pragma unroll
      for (int s = 0; s < kMaxPlanes; ++s)
        if (s < S) acc[s] += vb[(size_t)s * K + k];
    }
  }
  float* ob = out + (size_t)b * S * M + m;
#pragma unroll
  for (int s = 0; s < kMaxPlanes; ++s)
    if (s < S) ob[(size_t)s * M] = acc[s];
}

}  // namespace

extern "C" int rolo_keyed_sum(const float* values, const int32_t* keys_k,
                              const int32_t* keys_m, float* out, int B, int S,
                              int K, int M, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || S <= 0 || S > kMaxPlanes || K < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  keyed_sum_kernel<<<grid, kThreads, 0, stream>>>(values, keys_k, keys_m, out, S, K, M);
  return (int)cudaGetLastError();
}

// Keyed sum: out[b, s, m] = sum over k of values[b, s, k] where
// keys_k[b, k] == keys_m[b, m], for keys_k sorted ascending.
//
// Replaces the TPU kernel `_keyed_kernel` launched by `_keyed_matmul_pallas`
// (rolo_tpu/ops/voxel_join.py:96-167). There the sum is a one-hot matrix
// product on the MXU, because gathers and scatters serialize on a TPU.
// Hopper gathers well, so these kernels compute the function directly, in
// f32 with no bf16 split, and never form the one-hot matrix (2*S*K*M flops).
//
// Bound on the H100: memory. Each input read once and each output written
// once: at B = 16 and K = 8192 a polar join moves ~11.5 MB (3.4 us at
// 3.35 TB/s), a fine direct7 join ~46 MB (13.8 us), mostly its
// [16, 10, 57344] output. What the design does about it:
//   - join_kernel: a block stages its instance's sorted keys in shared
//     memory (32 KB at K = 8192; dynamic shared memory up to the 227 KB a
//     block may hold, so K <= 58,112) and serves thousands of queries from
//     them, so the binary search is ~13 shared-memory probes and not 13
//     dependent loads from device memory. A voxel table keeps a run's stats
//     in its first slot and zeros in the duplicate slots after it, so a
//     join of such a table (`heads`) reads the first slot alone, not the
//     run. A hit reads its S values in one pass: from a row-major table ([B, K, R] with R a multiple of 4, as
//     `build_voxel_map` keeps its stats) as R / 4 float4 loads, or from
//     plane-major values [B, S, K] as S loads. The output [B, S, M] is
//     written with neighbouring threads on neighbouring addresses.
//   - the voxel build (keys_m the same sorted keys as keys_k), in two
//     passes over the slots: each chunk of 8 slots of a run sums its values
//     once, then every slot adds its run's chunk sums in order and writes
//     the total. A value is read once and a slot reads L / 8 chunk sums,
//     where a join of the table against itself would read each run once per
//     slot (O(sum of L^2)) and a thread per run would wait on its run's
//     length (a polar voxel holds dozens of the bench's feature points).
//
// Contract (the wrapper checks shapes, types, devices, strides):
//   values f32 with element strides (sb, ss, sk) for [B, S, K], keys_k [B, K]
//   i32 sorted ascending per row, keys_m [B, M] i32, out [B, S, M] f32
//   contiguous, S <= 16. A query equal to INVALID_PACK (0x7FFFFFFF) returns
//   0: callers give sentinel slots zero values, so the TPU form adds nothing
//   there either.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kInvalidPack = 0x7FFFFFFF;
constexpr int kJoinThreads = 512;
constexpr int kRunThreads = 256;
constexpr int kChunk = 8;  // slots of a run one thread sums in a build
constexpr int kMaxSharedBytes = 232448;  // 227 KB: the most one block may hold
constexpr int kMaxSharedKeys = kMaxSharedBytes / 4;  // MAX_SHARED_KEYS in the wrapper

struct Values {
  const float* base;
  long long sb;  // element strides of [B, S, K]
  long long ss;
  long long sk;
};

// acc[s] += values[b, s, i] for s < S. kRows: ss == 1 and sk a multiple of
// 4 with 16-byte aligned rows, read as float4 (the row's padding included).
template <bool kRows>
__device__ __forceinline__ void add_column(float (&acc)[kMaxPlanes], const float* vb,
                                           const Values& v, int i, int S) {
  if (kRows) {
    const float4* row = reinterpret_cast<const float4*>(vb + (long long)i * v.sk);
#pragma unroll
    for (int c = 0; c < kMaxPlanes / 4; ++c) {
      if (4 * c < S) {
        const float4 x = __ldg(row + c);
        acc[4 * c] += x.x;
        acc[4 * c + 1] += x.y;
        acc[4 * c + 2] += x.z;
        acc[4 * c + 3] += x.w;
      }
    }
  } else {
    const float* col = vb + (long long)i * v.sk;
#pragma unroll
    for (int s = 0; s < kMaxPlanes; ++s)
      if (s < S) acc[s] += __ldg(col + s * v.ss);
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kJoinThreads)
join_kernel(Values v, const int32_t* __restrict__ keys_k, const int32_t* __restrict__ keys_m,
            float* __restrict__ out, int S, int K, int M, int per_block, int heads) {
  extern __shared__ int32_t keys[];
  const int b = blockIdx.y;
  const int32_t* kb = keys_k + (size_t)b * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) keys[i] = kb[i];
  __syncthreads();

  const float* vb = v.base + b * v.sb;
  const int m1 = min(M, (blockIdx.x + 1) * per_block);
  for (int m = blockIdx.x * per_block + threadIdx.x; m < m1; m += blockDim.x) {
    const int32_t key = keys_m[(size_t)b * M + m];
    float acc[kMaxPlanes];
#pragma unroll
    for (int s = 0; s < kMaxPlanes; ++s) acc[s] = 0.f;
    if (key != kInvalidPack) {
      int lo = 0, hi = K;  // lower bound: the first key >= key
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (keys[mid] < key) lo = mid + 1; else hi = mid;
      }
      if (heads) {  // only a run's first slot holds values (a voxel table)
        if (lo < K && keys[lo] == key) add_column<kRows>(acc, vb, v, lo, S);
      } else {
        for (int i = lo; i < K && keys[i] == key; ++i) add_column<kRows>(acc, vb, v, i, S);
      }
    }
    float* ob = out + (size_t)b * S * M + m;
#pragma unroll
    for (int s = 0; s < kMaxPlanes; ++s)
      if (s < S) ob[(size_t)s * M] = acc[s];
  }
}

// [s, e): the run of equal keys around slot k, by galloping then binary
// searches over the sorted keys in both directions.
__device__ __forceinline__ void run_bounds(const int32_t* kb, int K, int k, int32_t key, int& s,
                                           int& e) {
  int in = k, out = -1, step = 1;
  while (k - step >= 0 && kb[k - step] == key) {
    in = k - step;
    step <<= 1;
  }
  out = max(k - step, -1);
  while (in - out > 1) {
    const int mid = (in + out) >> 1;
    if (kb[mid] == key) in = mid; else out = mid;
  }
  s = in;
  in = k;
  step = 1;
  while (k + step < K && kb[k + step] == key) {
    in = k + step;
    step <<= 1;
  }
  out = min(k + step, K);
  while (out - in > 1) {
    const int mid = (in + out) >> 1;
    if (kb[mid] == key) in = mid; else out = mid;
  }
  e = out;
}

// Build, pass 1: each chunk of kChunk slots of a run (counted from the
// run's first slot) sums its values into partial[b, :, first slot of chunk].
__global__ void __launch_bounds__(kRunThreads)
run_chunks_kernel(Values v, const int32_t* __restrict__ keys, float* __restrict__ partial, int S,
                  int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int32_t* kb = keys + (size_t)b * K;
  const int32_t key = kb[k];
  if (key == kInvalidPack) return;
  int s, e;
  run_bounds(kb, K, k, key, s, e);
  if ((k - s) % kChunk != 0) return;
  const float* vb = v.base + b * v.sb;
  float acc[kMaxPlanes];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) acc[p] = 0.f;
  const int end = min(k + kChunk, e);
#pragma unroll 4
  for (int i = k; i < end; ++i) add_column<false>(acc, vb, v, i, S);
  float* pb = partial + (size_t)b * S * K + k;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p)
    if (p < S) pb[(size_t)p * K] = acc[p];
}

// Build, pass 2: every slot adds its run's chunk sums in order (the same
// bits in every slot of a run) and writes the total; sentinel slots 0.
__global__ void __launch_bounds__(kRunThreads)
run_totals_kernel(const int32_t* __restrict__ keys, const float* __restrict__ partial,
                  float* __restrict__ out, int S, int K) {
  const int b = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int32_t* kb = keys + (size_t)b * K;
  const int32_t key = kb[k];
  float acc[kMaxPlanes];
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p) acc[p] = 0.f;
  if (key != kInvalidPack) {
    int s, e;
    run_bounds(kb, K, k, key, s, e);
    const float* pb = partial + (size_t)b * S * K;
    for (int j = s; j < e; j += kChunk) {
#pragma unroll
      for (int p = 0; p < kMaxPlanes; ++p)
        if (p < S) acc[p] += __ldg(pb + (size_t)p * K + j);
    }
  }
  float* ob = out + (size_t)b * S * K + k;
#pragma unroll
  for (int p = 0; p < kMaxPlanes; ++p)
    if (p < S) ob[(size_t)p * K] = acc[p];
}

template <bool kRows>
cudaError_t launch_join(const Values& v, const int32_t* keys_k, const int32_t* keys_m,
                        float* out, int B, int S, int K, int M, int heads, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        join_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (rc != cudaSuccess) return rc;
    configured = true;
  }
  // About two blocks per SM over the whole batch; each stages its
  // instance's keys once and serves per_block queries.
  int blocks = (264 + B - 1) / B;
  blocks = max(1, min(blocks, (M + kJoinThreads - 1) / kJoinThreads));
  const int per_block = (M + blocks - 1) / blocks;
  const dim3 grid((M + per_block - 1) / per_block, B);
  join_kernel<kRows><<<grid, kJoinThreads, (size_t)K * sizeof(int32_t), stream>>>(
      v, keys_k, keys_m, out, S, K, M, per_block, heads);
  return cudaGetLastError();
}

}  // namespace

// Join: values [B, S, K] at element strides (sb, ss, sk); rows != 0 when
// ss == 1, sk % 4 == 0 and the rows are 16-byte aligned; heads != 0 when
// only the first slot of each run of equal keys holds non-zero values.
extern "C" int rolo_keyed_sum(const float* values, long long sb, long long ss, long long sk,
                              int rows, int heads, const int32_t* keys_k, const int32_t* keys_m,
                              float* out, int B, int S, int K, int M, cudaStream_t stream) {
  if (B <= 0 || M <= 0 || S <= 0 || S > kMaxPlanes || K < 0 || K > kMaxSharedKeys)
    return (int)cudaErrorInvalidValue;
  if (rows && (ss != 1 || sk % 4 != 0 || sk < ((S + 3) & ~3))) return (int)cudaErrorInvalidValue;
  const Values v{values, sb, ss, sk};
  return (int)(rows ? launch_join<true>(v, keys_k, keys_m, out, B, S, K, M, heads, stream)
                    : launch_join<false>(v, keys_k, keys_m, out, B, S, K, M, heads, stream));
}

// Build: out [B, S, K] = for each slot, the sum of its run of equal keys
// (keys [B, K] sorted ascending; INVALID_PACK slots 0); partial [B, S, K]
// is scratch.
extern "C" int rolo_keyed_sum_runs(const float* values, long long sb, long long ss,
                                   long long sk, const int32_t* keys, float* partial, float* out,
                                   int B, int S, int K, cudaStream_t stream) {
  if (B <= 0 || K <= 0 || S <= 0 || S > kMaxPlanes) return (int)cudaErrorInvalidValue;
  const Values v{values, sb, ss, sk};
  const dim3 grid((K + kRunThreads - 1) / kRunThreads, B);
  run_chunks_kernel<<<grid, kRunThreads, 0, stream>>>(v, keys, partial, S, K);
  run_totals_kernel<<<grid, kRunThreads, 0, stream>>>(keys, partial, out, S, K);
  return (int)cudaGetLastError();
}

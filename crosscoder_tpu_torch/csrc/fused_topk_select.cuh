// The selection shared by the fused encoder -> TopK kernels: fused_topk.cu
// (K2, the pre-activation tile from the compute dtype's product) and
// fused_topk_q.cu (K3, the tile from the int8 block-scaled product). Each
// kernel brings its own tile product; both rank a tile's keys and merge the
// per-tile candidates here, so their selection is one piece of code.
//
// Selection key: the f32 bit pattern of the relu'd value, with every NaN
// mapped to 0x7F800001 (just above +inf) and every value <= 0 (-0.0,
// negatives, -inf) to 0. Candidates are ordered by (key desc, index asc)
// through one int64 composite (key << 32 | 2^31-1-idx), so ties go to the
// lowest index. Key 0 never enters; a NaN takes a slot and is dropped at
// emit (its value is not > 0).
//
// A tile's candidates: the best k composites of one row over kCW columns,
// in rank order, zero-padded, at cand[row, tile, :] ([B, n_tiles, k]).
// The merge: one block per row ranks the n_tiles * k candidates staged in
// shared memory (only those at or above the k-th best tile head, a lower
// bound of the k-th best candidate) and emits the k winners in ascending
// index order. When a row's candidates exceed shared memory, a first level
// merges groups of tiles into candidate lists of the same format.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fsel {

constexpr int kCW = 128;            // dictionary columns per candidate tile
constexpr int kMergeThreads = 256;
constexpr int kSent = 0x7F800001;
constexpr int kInfBits = 0x7F800000;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The selection key of a pre-activation already rounded to the compute dtype.
__device__ __forceinline__ int select_key(float hc) {
  return isnan(hc) ? kSent : (hc > 0.f ? __float_as_int(hc) : 0);
}

__device__ __forceinline__ long long composite(int key, int col) {
  return key > 0 ? ((long long)key << 32) | (long long)(0x7FFFFFFF - col) : 0LL;
}

// One warp writes a row's tile candidates: `keys` holds the row's kCW
// composites (shared memory), `out` is cand[row, tile, :]. The rank of a
// candidate is the number of composites that beat it.
__device__ __forceinline__ void rank_row_candidates(const long long* keys, long long* out, int k,
                                                    int lane) {
  constexpr int PER_LANE = kCW / 32;
  long long mine[PER_LANE];
  int rank[PER_LANE];
  int npos = 0;
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u) {
    mine[u] = keys[lane + 32 * u];
    rank[u] = 0;
    npos += mine[u] > 0;
  }
  for (int c = 0; c < kCW; ++c) {
    const long long o = keys[c];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) rank[u] += o > mine[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) npos += __shfl_xor_sync(0xffffffffu, npos, o);
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u)
    if (mine[u] > 0 && rank[u] < k) out[rank[u]] = mine[u];
  for (int s = min(npos, k) + lane; s < k; s += 32) out[s] = 0;
}

// Block (row, g) merges tiles [g * group, g * group + group) of a row's
// row_tiles candidate lists; with `out`, it writes the best k in rank order
// to out[row, g, :] instead of emitting (vals, idx).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const long long* __restrict__ cand,  // [B, row_tiles, k]
                  T* __restrict__ vals,                // [B, k]
                  int* __restrict__ idx,               // [B, k]
                  long long* __restrict__ out,         // [B, n_groups, k] or null
                  int row_tiles, int group, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x, g = blockIdx.y;
  const int n_tiles = min(group, row_tiles - g * group);
  long long* cs = reinterpret_cast<long long*>(smem);  // [n_tiles * k]
  const int N = n_tiles * k;
  long long* sel = cs + N;                              // [k]
  __shared__ long long theta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* base = cand + (size_t(row) * row_tiles + size_t(g) * group) * k;
  for (int i = tid; i < N; i += kMergeThreads) cs[i] = base[i];
  for (int i = tid; i < k; i += kMergeThreads) sel[i] = 0;
  if (tid == 0) theta = 0;
  __syncthreads();

  // k-th best tile head: at least k candidates are >= it
  if (n_tiles >= k) {
    for (int t = tid; t < n_tiles; t += kMergeThreads) {
      const long long h = cs[t * k];
      int cnt = 0;
      for (int u = 0; u < n_tiles; ++u) cnt += cs[u * k] > h;
      if (cnt == k - 1) theta = h;
    }
  }
  __syncthreads();
  const long long th = theta;

  for (int e = warp; e < N; e += kMergeThreads / 32) {
    const long long c = cs[e];
    if (c == 0 || c < th) continue;
    int cnt = 0;
    for (int i = lane; i < N; i += 32) cnt += cs[i] > c;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lane == 0 && cnt < k) sel[cnt] = c;
  }
  __syncthreads();
  if (out != nullptr) {
    for (int i = tid; i < k; i += kMergeThreads)
      out[(size_t(row) * gridDim.y + g) * k + i] = sel[i];
    return;
  }

  // emit the winners with a positive value, lowest index first
  int n_emit = 0;
  for (int s = 0; s < k; ++s) {
    const int key = int(sel[s] >> 32);
    n_emit += key > 0 && key <= kInfBits;
  }
  for (int s = tid; s < k; s += kMergeThreads) {
    const long long c = sel[s];
    const int key = int(c >> 32);
    if (key > 0 && key <= kInfBits) {
      const int id = 0x7FFFFFFF - int(c & 0xFFFFFFFFLL);
      int pos = 0;
      for (int u = 0; u < k; ++u) {
        const long long c2 = sel[u];
        const int key2 = int(c2 >> 32);
        const int id2 = 0x7FFFFFFF - int(c2 & 0xFFFFFFFFLL);
        pos += key2 > 0 && key2 <= kInfBits && id2 < id;
      }
      vals[size_t(row) * k + pos] = from_f<T>(__int_as_float(key));
      idx[size_t(row) * k + pos] = id;
    }
    if (s >= n_emit) {
      vals[size_t(row) * k + s] = from_f<T>(0.f);
      idx[size_t(row) * k + s] = 0;
    }
  }
}

// The merge of cand [B, n_tiles, k] into (vals, idx). group: the tiles
// whose candidates one merge block stages (n_tiles when they all fit, else
// cand2 [B, n_groups, k] takes a first level).
template <typename T>
int launch_merge(const void* cand, void* cand2, void* vals, void* idx, int B, int n_tiles, int k,
                 int group, cudaStream_t stream) {
  const int n_groups = (n_tiles + group - 1) / group;
  const int widest = n_groups > 1 ? (group > n_groups ? group : n_groups) : n_tiles;
  const size_t smem = (size_t(widest) * k + k) * sizeof(long long);
  auto kern = topk_merge_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long* c = static_cast<const long long*>(cand);
  int row_tiles = n_tiles;
  if (n_groups > 1) {
    kern<<<dim3(B, n_groups), kMergeThreads, smem, stream>>>(
        c, nullptr, nullptr, static_cast<long long*>(cand2), n_tiles, group, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    c = static_cast<const long long*>(cand2);
    row_tiles = n_groups;
  }
  kern<<<dim3(B, 1), kMergeThreads, smem, stream>>>(c, static_cast<T*>(vals),
                                                    static_cast<int*>(idx), nullptr, row_tiles,
                                                    row_tiles, k);
  return int(cudaGetLastError());
}

}  // namespace fsel

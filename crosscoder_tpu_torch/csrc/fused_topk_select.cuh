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
// The tensor-core kernels (K2 in bf16, K3) write them from the tile's
// accumulators with TileTopk: each consumer warpgroup stages its 64 rows'
// keys in shared memory and a warp bitonic-sorts each row of 128 (bf16:
// 32-bit composites, the bf16 key's 16 bits then 127 - the column in the
// tile, since a bf16 pattern's low 16 f32 bits are 0; f32: the 64-bit
// composites, built in registers from the staged 32-bit keys). The
// CUDA-core f32 pass of K2 ranks with rank_row_candidates.
// The merge: one block per row ranks the n_tiles * k candidates staged in
// shared memory (only those at or above the k-th best tile head, a lower
// bound of the k-th best candidate) and emits the k winners in ascending
// index order. When a row's candidates exceed shared memory, a first level
// merges groups of tiles into candidate lists of the same format.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile_sm90.cuh"

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

// --- the tensor-core tiles' epilogue (TileTopk) ---------------------------

constexpr int kKeyPitch = etile::kBN + 8;   // 32-bit words a staged row: 2-way stores, the minimum
constexpr int kNanKey16 = 0x7F81;           // a NaN's 16-bit key: just above +inf's 0x7F80

__device__ __forceinline__ uint32_t key16(float h) {
  const __nv_bfloat16 hb = __float2bfloat16_rn(h);
  const float hc = __bfloat162float(hb);
  return isnan(hc) ? kNanKey16 : (hc > 0.f ? uint32_t(__bfloat16_as_ushort(hb)) : 0u);
}

// The 64-bit candidate of a staged bf16 composite of tile column c0 + ...
__device__ __forceinline__ long long wide_composite(uint32_t m, int c0) {
  const int k16 = int(m >> 16);
  const int key = k16 == kNanKey16 ? kSent : k16 << 16;
  return composite(key, c0 + 127 - int(m & 0xFFFFu));
}

// A bitonic sort of one warp's 128 values, descending: lane l holds
// positions 4l .. 4l + 3 (strides 1 and 2 inside a lane, the others across
// lanes by shuffles); position e then holds the value of rank e.
template <typename V>
__device__ __forceinline__ void bitonic_desc128(V (&v)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= etile::kBN; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * lane + u;
          const V o = __shfl_xor_sync(0xffffffffu, v[u], stride >> 2);
          // the lower position of a pair keeps the larger when the run descends
          const bool larger = ((e & stride) == 0) == ((e & size) == 0);
          v[u] = larger ? (v[u] > o ? v[u] : o) : (v[u] < o ? v[u] : o);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u & stride) continue;
          const V a = v[u], b = v[u | stride];
          const bool desc = ((4 * lane + u) & size) == 0;
          const V hi = a > b ? a : b, lo = a > b ? b : a;
          v[u] = desc ? hi : lo;
          v[u | stride] = desc ? lo : hi;
        }
      }
    }
  }
}

// The epilogue of a tensor-core tile that writes each row's tile
// candidates: the bias added in f32, the sum rounded to T (bf16 or f32)
// as `pre_acts` does, rows >= B and columns >= width masked to key 0.
// width % 8 == 0, so columns c and c + 1 are in or out together.
template <typename T>
struct TileTopk {
  const float* b;
  long long* cand;
  uint32_t* keys;    // [kBM][kKeyPitch]
  int B, width, k, n_tiles;

  __device__ __forceinline__ void operator()(float (&acc)[64], int row0, int c0, int cw, int t) {
    constexpr bool kBf16 = sizeof(T) == 2;
    uint32_t* kw = keys + cw * 64 * kKeyPitch;
    const int rbase = row0 + cw * 64;
    etile::wg_sync(cw);                       // the previous tile's ranking is done with kw
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = etile::frag_row(i, t), c = etile::frag_col(i, t);
      uint32_t k0 = 0, k1 = 0;
      if (rbase + r < B && c0 + c < width) {
        const float2 bb = *reinterpret_cast<const float2*>(b + c0 + c);
        if (kBf16) {
          k0 = key16(acc[i] + bb.x);
          k1 = key16(acc[i + 1] + bb.y);
          k0 = k0 ? (k0 << 16) | uint32_t(127 - c) : 0u;
          k1 = k1 ? (k1 << 16) | uint32_t(126 - c) : 0u;
        } else {
          k0 = uint32_t(select_key(acc[i] + bb.x));
          k1 = uint32_t(select_key(acc[i + 1] + bb.y));
        }
      }
      *reinterpret_cast<uint2*>(kw + r * kKeyPitch + c) = make_uint2(k0, k1);
    }
    etile::wg_sync(cw);
    const int warp = t >> 5, lane = t & 31, tile = c0 / etile::kBN;
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      if (rbase + r >= B) break;
      const uint4 q = *reinterpret_cast<const uint4*>(kw + r * kKeyPitch + 4 * lane);
      long long* out = cand + (size_t(rbase + r) * n_tiles + tile) * k;
      if (kBf16) {
        uint32_t v[4] = {q.x, q.y, q.z, q.w};
        bitonic_desc128(v, lane);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * lane + u;
          if (e < k) out[e] = v[u] != 0u ? wide_composite(v[u], c0) : 0;
        }
      } else {
        const uint32_t key[4] = {q.x, q.y, q.z, q.w};
        unsigned long long v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = (unsigned long long)composite(int(key[u]), c0 + 4 * lane + u);
        bitonic_desc128(v, lane);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = 4 * lane + u;
          if (e < k) out[e] = (long long)v[u];
        }
      }
    }
  }
};

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

// Exact per-row TopK mask of bf16 or f32 rows of any width, for Hopper
// (sm_90a): K7, in two routes chosen by width.
//
// Replaces the Pallas TPU kernels crosscoder_tpu/ops/topk_pallas.py
// `_bisect_kernel` and `_emit_kernel` (reached through `_topk_chunked_impl`
// <- `_topk_fwd_impl` <- `topk` for rows too wide for one VMEM block: bf16
// above 2^16, f32 above the single-block gate). Those walk a row in
// 4096-column chunks over a sequential grid: a multi-threshold bisection
// that carries per-row counts across chunks, then an emit that carries the
// count of ties seen in earlier chunks.
//
// Keys. bf16 entries take K5's clamped 15-bit pattern (sign-set patterns 0
// unless a negative NaN, which maps to 0x7FFE; positive patterns clamped at
// 0x7FFE); f32 entries their pattern when the sign bit is clear, else 0 (a
// negative NaN is never kept). The value written is the key.
//
// Semantics kept from the TPU kernels. The bisection searches [0, top) with
// top = 2^15 (bf16) or 0x7F800001 (f32, one above +inf) and takes
// count(key >= top) as 0. So kth is the largest p < top with
// count(key >= p) >= k (0 when fewer than k keys are positive), and
// count(> kth) is count(key >= kth + 1), or 0 when kth + 1 == top: an f32
// row whose top k holds a NaN keeps every NaN and up to k entries at +inf
// (ROADMAP C6; bf16 keys never reach top). The emit keeps every key above
// kth and the lowest-column k - count(> kth) keys equal to it.
//
// Cluster route (topk_cluster_launch, topk_slice.cuh): a row of up to
// eight 64 KB slices (2^18 bf16 or 2^17 f32 columns; the slicing is
// ops/topk_pallas.py `topk_plan`'s) goes to one thread-block cluster, each
// block holding one slice in shared memory: one read of the row, the radix
// passes over shared memory with the histograms summed across the cluster
// through distributed shared memory, one write.
//
// Streaming route (topk_chunked_launch, below), for wider rows: a
// persistent grid (two blocks an SM), each block taking rows in turn. Per
// row, the radix select of radix_select.cuh over the keys clamped below
// top: bf16 in up to two passes (bits 14-8, 7-0), f32 in up to four (31-24
// ... 7-0), each a read of the row from device memory, the histogram in one
// copy per warp. The emit reads the row once more and writes it: one
// compare a column when every tie at kth is kept (the common case, and
// always when kth is 0), else a walk in column order with a block prefix
// count of the ties carried across stretches of the row (radix::emit_ties).
//
// Bound. The function reads h once and writes out once: 2 x 1.07 GB at
// [4096, 131072] bf16 (0.64 ms at 3.35 TB/s), 2 x 537 MB at [4096, 32768]
// f32 (0.32 ms). The cluster route moves exactly that; the streaming route
// reads the row once a select pass and once more to emit: at most 3 reads
// in bf16, 5 in f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"
#include "topk_slice.cuh"

namespace {

using radix::kBins;
using radix::kThreads;
using radix::kWarps;
constexpr int kUnroll = 4;           // 8-column groups a thread loads before counting

__device__ __forceinline__ unsigned key_bf16(unsigned p) {
  if (p >= 0x8000u) return p > 0xFF80u ? 0x7FFEu : 0u;
  return p < 0x7FFEu ? p : 0x7FFEu;
}

__device__ __forceinline__ unsigned key_f32(unsigned b) { return (b & 0x80000000u) ? 0u : b; }

// The keys of columns [c, c + 8) of a row (0 past W).
template <bool BF16>
__device__ __forceinline__ void load8(const void* row, int c, int W, int vec, unsigned* key) {
  if (BF16) {
    const uint16_t* r = static_cast<const uint16_t*>(row);
    if (vec) {
      union { uint4 u; uint16_t s[8]; } d;
      d.u = __ldg(reinterpret_cast<const uint4*>(r + c));
#pragma unroll
      for (int j = 0; j < 8; ++j) key[j] = key_bf16(d.s[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) key[j] = c + j < W ? key_bf16(r[c + j]) : 0u;
    }
  } else {
    const unsigned* r = static_cast<const unsigned*>(row);
    if (vec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(r + c));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(r + c + 4));
      key[0] = key_f32(a.x); key[1] = key_f32(a.y); key[2] = key_f32(a.z); key[3] = key_f32(a.w);
      key[4] = key_f32(b.x); key[5] = key_f32(b.y); key[6] = key_f32(b.z); key[7] = key_f32(b.w);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) key[j] = c + j < W ? key_f32(r[c + j]) : 0u;
    }
  }
}

template <bool BF16>
__device__ __forceinline__ void store8(void* row, int c, int W, int vec, const unsigned* o) {
  if (BF16) {
    uint16_t* r = static_cast<uint16_t*>(row);
    if (vec) {
      union { uint4 u; uint16_t s[8]; } d;
#pragma unroll
      for (int j = 0; j < 8; ++j) d.s[j] = uint16_t(o[j]);
      *reinterpret_cast<uint4*>(r + c) = d.u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < W) r[c + j] = uint16_t(o[j]);
    }
  } else {
    unsigned* r = static_cast<unsigned*>(row);
    if (vec) {
      *reinterpret_cast<uint4*>(r + c) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(r + c + 4) = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < W) r[c + j] = o[j];
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
topk_chunked_kernel(const void* __restrict__ h, void* __restrict__ out, int R, int W, int k,
                    int vec) {
  __shared__ unsigned hist[kWarps * kBins];
  __shared__ int ws[2 * kWarps];
  __shared__ int sel[3];
  constexpr unsigned kTopM1 = BF16 ? 0x7FFFu : 0x7F800000u;   // top - 1: keys clamp here
  constexpr int kFirstShift = BF16 ? 8 : 24;
  constexpr size_t kBytes = BF16 ? 2 : 4;
  const int tid = threadIdx.x;
  constexpr int kStride = kThreads * 8;

  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const char* hr = static_cast<const char*>(h) + size_t(row) * W * kBytes;
    char* orow = static_cast<char*>(out) + size_t(row) * W * kBytes;

    // ---- select: radix passes over the keys clamped below top, a
    // histogram copy per warp
    const radix::Select s = radix::radix_select<kFirstShift, kWarps>(
        k, hist, ws, sel, [&](int shift, unsigned mask, unsigned prefix, unsigned* mine) {
          for (int c0 = tid * 8; c0 < W; c0 += kStride * kUnroll) {
            unsigned key[kUnroll][8];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int c = c0 + u * kStride;
              if (c < W) {
                load8<BF16>(hr, c, W, vec, key[u]);
              } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) key[u][j] = 0u;
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
                radix::count_key(min(key[u][j], kTopM1), shift, mask, prefix, mine);
            }
          }
        });
    const unsigned kth = s.kth;
    // ties to keep: k - count(> kth), where count(> kth) is taken as 0 at top - 1
    const int need = kth == kTopM1 ? k : s.need;

    // ---- emit
    if (kth == 0u || need >= s.eq) {
      // every tie kept (eq counts the clamped keys in kth's bin, a superset
      // of the ties): out = key where key >= kth
      for (int c0 = tid * 8; c0 < W; c0 += kStride * kUnroll) {
        unsigned key[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + u * kStride;
          if (c < W) load8<BF16>(hr, c, W, vec, key[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = c0 + u * kStride;
          if (c < W) {
#pragma unroll
            for (int j = 0; j < 8; ++j) key[u][j] = key[u][j] >= kth ? key[u][j] : 0u;
            store8<BF16>(orow, c, W, vec, key[u]);
          }
        }
      }
    } else {
      radix::emit_ties<8>(
          W, kth, need, ws, [&](int c, unsigned* key) { load8<BF16>(hr, c, W, vec, key); },
          [&](int c, const unsigned* key) { store8<BF16>(orow, c, W, vec, key); });
    }
    __syncthreads();   // hist, ws and sel are reused by the next row
  }
}

}  // namespace

extern "C" int topk_chunked_launch(const void* h, void* out, int R, int W, int k, int vec,
                                   int bf16, void* stream) {
  if (R == 0 || W == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const int grid = R < 2 * sms ? R : 2 * sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    topk_chunked_kernel<true><<<grid, kThreads, 0, s>>>(h, out, R, W, k, vec);
  else
    topk_chunked_kernel<false><<<grid, kThreads, 0, s>>>(h, out, R, W, k, vec);
  return int(cudaGetLastError());
}

extern "C" int topk_cluster_launch(const void* h, void* out, int R, int W, int k, int vec, int S,
                                   int C, int bf16, void* stream) {
  if (C < 1 || C > tslice::kMaxCluster || S <= 0 || S % 8 != 0 ||
      size_t(C) * size_t(S) < size_t(W))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? tslice::launch<true>(h, out, R, W, S, C, k, vec, s)
              : tslice::launch<false>(h, out, R, W, S, C, k, vec, s);
}

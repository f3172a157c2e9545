// Exact per-row TopK mask of f32 rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/topk_pallas.py
// `_topk_mask_kernel` (reached through `_topk_fwd_impl` <- `topk` for f32
// rows that pass `_single_block_supported`): out[r, c] = relu(h[r, c]) where
// (h[r, c], c) is among the k largest of row r by (value desc, column asc),
// else +0.0.
//
// Semantics kept from the TPU kernel, on bit patterns. Each entry's key is
// its f32 pattern when the sign bit is clear (positive values, +inf and
// positive NaNs, which rank by their payload above +inf) and 0 otherwise
// (negatives, -0.0, negative NaNs: never kept as anything but a zero). The
// TPU kernel bisects the 31-bit patterns of max(h, 0) for the k-th largest
// key v*, then keeps every key above v* and the lowest-column
// k - count(key > v*) keys equal to it. A row with fewer than k positive
// keys keeps all of them. The value written is the key itself.
//
// Design. One block per row. The row's keys are staged once in shared
// memory (4 bytes a column: 64 KB at width 16384, so three blocks fit an
// SM). v* is found by the radix select of radix_select.cuh instead of the
// TPU's 31 halvings: up to four passes over shared memory, one 8-bit digit
// each (bits 31-24, 23-16, 15-8, 7-0), the histogram in four warp-group
// copies. Ties at v* are kept by column order: when every tie is kept (the
// common case, and always when v* = 0) the emit is one compare a column;
// otherwise it walks the row in column order with a block prefix count of
// the ties (radix::emit_ties).
//
// Bound. The function reads h once and writes out once: at [4096, 16384]
// f32 that is 2 x 268 MB, 0.16 ms at 3.35 TB/s; it does no tensor-core
// work. Global memory is touched in exactly those two passes with 16-byte
// accesses; the select runs out of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"

namespace {

using radix::kBins;
using radix::kThreads;
using radix::kWarps;
constexpr int kSub = 4;              // histogram copies (warp % kSub)

__device__ __forceinline__ unsigned key_of(unsigned b) { return (b & 0x80000000u) ? 0u : b; }

__global__ void __launch_bounds__(kThreads)
topk_mask_f32_kernel(const float* __restrict__ h, float* __restrict__ out, int W, int Wp, int k,
                     int vec) {
  extern __shared__ __align__(16) unsigned sk[];    // Wp keys, zero-padded
  __shared__ unsigned hist[kSub * kBins];
  __shared__ int ws[2 * kWarps];
  __shared__ int sel[3];
  const size_t row = blockIdx.x;
  const unsigned* hr = reinterpret_cast<const unsigned*>(h) + row * size_t(W);
  unsigned* orow = reinterpret_cast<unsigned*>(out) + row * size_t(W);
  const int tid = threadIdx.x;

  // stage: one read of the row into shared memory
  for (int c = tid * 4; c < Wp; c += kThreads * 4) {
    uint4 v;
    if (vec) {
      v = __ldg(reinterpret_cast<const uint4*>(hr + c));
      v = make_uint4(key_of(v.x), key_of(v.y), key_of(v.z), key_of(v.w));
    } else {
      v.x = c < W ? key_of(hr[c]) : 0u;
      v.y = c + 1 < W ? key_of(hr[c + 1]) : 0u;
      v.z = c + 2 < W ? key_of(hr[c + 2]) : 0u;
      v.w = c + 3 < W ? key_of(hr[c + 3]) : 0u;
    }
    *reinterpret_cast<uint4*>(sk + c) = v;
  }
  __syncthreads();

  const radix::Select s = radix::radix_select<24, kSub>(
      k, hist, ws, sel, [&](int shift, unsigned mask, unsigned prefix, unsigned* mine) {
        for (int c = tid * 4; c < Wp; c += kThreads * 4) {
          const uint4 q = *reinterpret_cast<const uint4*>(sk + c);
          radix::count_key(q.x, shift, mask, prefix, mine);
          radix::count_key(q.y, shift, mask, prefix, mine);
          radix::count_key(q.z, shift, mask, prefix, mine);
          radix::count_key(q.w, shift, mask, prefix, mine);
        }
      });
  const unsigned kth = s.kth;
  auto store4 = [&](int c, const unsigned* o) {
    if (vec) {
      *reinterpret_cast<uint4*>(orow + c) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < W) orow[c + j] = o[j];
    }
  };

  if (kth == 0u || s.need >= s.eq) {
    // every tie kept: out = key where key >= kth (kth 0: every positive)
    for (int c = tid * 4; c < Wp; c += kThreads * 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(sk + c);
      const unsigned o[4] = {v.x >= kth ? v.x : 0u, v.y >= kth ? v.y : 0u,
                             v.z >= kth ? v.z : 0u, v.w >= kth ? v.w : 0u};
      store4(c, o);
    }
    return;
  }
  radix::emit_ties<4>(
      Wp, kth, s.need, ws,
      [&](int c, unsigned* key) {
        const uint4 v = *reinterpret_cast<const uint4*>(sk + c);
        key[0] = v.x;
        key[1] = v.y;
        key[2] = v.z;
        key[3] = v.w;
      },
      store4);
}

}  // namespace

extern "C" int topk_mask_f32_launch(const void* h, void* out, int R, int W, int k, int vec,
                                    void* stream) {
  if (R == 0 || W == 0) return 0;
  const int Wp = (W + 3) / 4 * 4;
  const size_t smem = size_t(Wp) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(topk_mask_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  topk_mask_f32_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<float*>(out), W, Wp, k, vec);
  return int(cudaGetLastError());
}

// Exact per-row TopK mask of bf16 rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/topk_pallas.py
// `_topk_mask_kernel_composite` (reached through `_topk_fwd_impl` <- `topk`):
// out[r, c] = relu(h[r, c]) where (h[r, c], c) is among the k largest of
// row r by (value desc, column asc), else +0.0. Rows are bf16, at most 2^16
// wide.
//
// Semantics kept from the TPU kernel. Each bf16 bit pattern p is clamped
// first: a sign-set pattern is 0 unless it is a negative NaN (p > 0xFF80),
// which maps to 0x7FFE; a positive pattern is clamped at 0x7FFE. So every
// NaN ranks above +inf, -0.0 and negatives rank as 0, and the value
// written is the clamped pattern itself (the TPU kernel rebuilds it from
// the composite key's high bits). The TPU kernel bisects once on the
// distinct composite key (p << width_bits) | (width - 1 - col); selecting
// the k largest composite keys is the same as taking every p above the
// k-th largest pattern v* and the lowest-column (k - count(p > v*)) of the
// patterns equal to v*, which is what this kernel does. Rows with fewer
// than k positives keep all of them and zeros elsewhere.
//
// Design. One block per row. The row's clamped 16-bit patterns are staged
// in shared memory (2 bytes a column: 64 KB at width 32768, so three
// blocks fit an SM). The block then bisects the pattern range [0, max]
// for v* (at most 15 halvings, each a count over shared memory reduced
// across the block by warp reductions), finds the column of the last tie
// kept by one prefix-count pass over per-thread column chunks, and writes
// the row. Rows whose v* is 0 need no tie pass: the output is the clamped
// pattern itself.
//
// Bound. The function reads h once and writes out once: at [4096, 32768]
// bf16 that is 2 x 268 MB, 0.16 ms at 3.35 TB/s; it does no tensor-core
// work. Global memory is touched in exactly those two passes with 16-byte
// accesses; the bisection runs out of shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

union Pack8 {
  uint4 u;
  uint16_t s[8];
};
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint16_t clamp_pattern(unsigned p) {
  if (p >= 0x8000u) return p > 0xFF80u ? 0x7FFE : 0;
  return p < 0x7FFEu ? uint16_t(p) : uint16_t(0x7FFE);
}

// Block-wide sum / max with one barrier: `red` holds two buffers of
// kWarps slots, used alternately (`parity`), so a call never overwrites
// a buffer another thread may still be reading from the call before.
__device__ __forceinline__ int block_sum(int v, int* red, int parity) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[parity * kWarps + (threadIdx.x >> 5)] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[parity * kWarps + w];
  return s;
}

__device__ __forceinline__ int block_max(int v, int* red, int parity) {
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[parity * kWarps + (threadIdx.x >> 5)] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s = max(s, red[parity * kWarps + w]);
  return s;
}

__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const uint16_t* __restrict__ h, uint16_t* __restrict__ out, int W, int Wp,
                 int k, int vec) {
  extern __shared__ __align__(16) uint16_t sp[];   // Wp clamped patterns, zero-padded
  __shared__ int red[2 * kWarps];
  __shared__ int scan[kWarps];
  __shared__ int cstar_s;
  const size_t row = blockIdx.x;
  const uint16_t* hr = h + row * size_t(W);
  uint16_t* orow = out + row * size_t(W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage: one read of the row, clamped, into shared memory
  int mx = 0;
  for (int c = tid * 8; c < Wp; c += kThreads * 8) {
    Pack8 v;
    if (vec) {
      Pack8 in;
      in.u = __ldg(reinterpret_cast<const uint4*>(hr + c));
#pragma unroll
      for (int j = 0; j < 8; ++j) v.s[j] = clamp_pattern(in.s[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v.s[j] = c + j < W ? clamp_pattern(hr[c + j]) : uint16_t(0);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = max(mx, int(v.s[j]));
    *reinterpret_cast<uint4*>(sp + c) = v.u;
  }
  int parity = 0;
  mx = block_max(mx, red, parity);
  parity ^= 1;

  // bisection for v*, the k-th largest pattern:
  // count(p >= lo) >= k and count(p >= hi) < k throughout
  int lo = 0, hi = mx + 1, cnt_hi = 0;
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    int cnt = 0;
    for (int c = tid * 8; c < Wp; c += kThreads * 8) {
      Pack8 p;
      p.u = *reinterpret_cast<const uint4*>(sp + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) cnt += int(p.s[j]) >= mid;
    }
    cnt = block_sum(cnt, red, parity);
    parity ^= 1;
    if (cnt >= k) {
      lo = mid;
    } else {
      hi = mid;
      cnt_hi = cnt;
    }
  }
  const int vk = lo;
  const int need = k - cnt_hi;   // ties at vk to keep, lowest columns first

  int cstar = -1;                // last kept tie column
  if (vk > 0) {
    const int cpt = ((Wp / 8 + kThreads - 1) / kThreads) * 8;
    const int c0 = min(tid * cpt, Wp), c1 = min(c0 + cpt, Wp);
    int t = 0;
    for (int c = c0; c < c1; ++c) t += sp[c] == vk;
    int incl = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kWarps ? scan[lane] : 0;
      int wi = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += y;
      }
      if (lane < kWarps) scan[lane] = wi - w;   // exclusive warp offsets
    }
    __syncthreads();
    const int prefix = scan[warp] + incl - t;
    if (t > 0 && prefix < need && need <= prefix + t) {
      int r = need - prefix;
      for (int c = c0; c < c1; ++c) {
        if (sp[c] == vk && --r == 0) {
          cstar_s = c;
          break;
        }
      }
    }
    __syncthreads();
    cstar = cstar_s;
  }

  // emit: one write of the row
  for (int c = tid * 8; c < Wp; c += kThreads * 8) {
    Pack8 p, o;
    p.u = *reinterpret_cast<const uint4*>(sp + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pj = p.s[j];
      o.s[j] = (pj > vk || (pj == vk && c + j <= cstar)) ? uint16_t(pj) : uint16_t(0);
    }
    if (vec) {
      *reinterpret_cast<uint4*>(orow + c) = o.u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < W) orow[c + j] = o.s[j];
    }
  }
}

}  // namespace

extern "C" int topk_mask_launch(const void* h, void* out, int R, int W, int k, int vec,
                                void* stream) {
  const int Wp = (W + 7) / 8 * 8;
  const size_t smem = size_t(Wp) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(topk_mask_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  topk_mask_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(h), static_cast<uint16_t*>(out), W, Wp, k, vec);
  return int(cudaGetLastError());
}

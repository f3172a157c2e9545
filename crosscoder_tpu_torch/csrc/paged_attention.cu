// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/paged_attention.py
// `_rpa_kernel` (reached through `_rpa_call` / `paged_attention`): per
// document, causal (+ sliding-window) attention with logit softcap and GQA,
// reading K/V only from the document's own ceil(len/page) pages of a page
// pool through a page table, folded with an online softmax.
//
// Design. The TPU kernel walks its page loop as a sequential grid axis and
// keeps a whole document's query block in VMEM. Hopper blocks run in no
// order and have 227 KB of shared memory, so here:
//   - grid (doc, kv_head, q_tile): a block owns 32 query rows, the g query
//     heads of one KV head times 32/g positions, and loops over the pages
//     its rows can see: from the first page inside the window to the last
//     page at or before both the tile's last position and the length. A
//     tile that starts at or after the length writes zeros (its rows are
//     discarded by every caller).
//   - each block reads its own page-table row and length (no scalar
//     prefetch); a page's K and V are staged in shared memory as fp32
//     (K rows padded by one word so the per-column dot products hit 32
//     distinct banks), logits and the online-softmax state (m, l) are fp32,
//     the accumulator lives in registers: thread (column d, row group) owns
//     acc[rows][d].
//   - probabilities are masked explicitly (p = 0 where the mask is false),
//     as in the TPU kernel, so a fully masked page cannot add exp(0) = 1.
//   - rows whose denominator is 0 are written as 0; output is in the input
//     dtype.
// Shared memory at head_dim 256, page 64: q 32 KB + K 64.3 KB + V 64 KB +
// p 8 KB = 169 KB, one block per SM.
//
// Bound. At the serve shapes (8 docs x 1024 tokens, 8 heads / 4 KV heads,
// head_dim 256, bf16) the function moves Q, K, V and O once: about 100 MB,
// 30 us at 3.35 TB/s, against about 34 GFLOP of causal QK^T and PV, 35 us
// at the bf16 tensor-core peak. This first version multiplies on the CUDA
// cores from shared memory, so it is bound by fp32 issue rate instead;
// tensor cores (mma/wgmma) and TMA staging are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;  // the JAX package's NEG_INF
constexpr int kThreads = 256;
constexpr int kRows = 32;  // query rows per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool visible(int t, int kpos, int L, int window) {
  return kpos <= t && kpos < L && (window == 0 || t - kpos < window);
}

template <int HD, int PAGE>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kRows) * HD + size_t(PAGE) * (HD + 1) + size_t(PAGE) * HD +
          size_t(kRows) * PAGE + 3 * kRows);
}

template <typename T, int HD, int PAGE>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const T* __restrict__ q,          // [D, S, H, HD]
           const T* __restrict__ kv_pages,   // [P, 2, KV, PAGE, HD]
           const int* __restrict__ page_tbl, // [D, S / PAGE]
           const int* __restrict__ lengths,  // [D]
           T* __restrict__ out,              // [D, S, H, HD]
           int S, int H, int KV, float scale, float softcap, int window) {
  constexpr int KSTRIDE = HD + 1;
  constexpr int LGROUPS = kThreads / PAGE;  // logits: row groups
  constexpr int LROWS = kRows / LGROUPS;    // logits rows per thread
  constexpr int VGROUPS = kThreads / HD;    // PV: row groups
  constexpr int VROWS = kRows / VGROUPS;    // PV rows per thread
  constexpr int CPL = PAGE / 32;            // softmax columns per lane

  extern __shared__ float smem[];
  float* qs = smem;                   // [kRows][HD], pre-scaled
  float* ks = qs + kRows * HD;        // [PAGE][HD + 1]
  float* vs = ks + PAGE * KSTRIDE;    // [PAGE][HD]
  float* ps = vs + PAGE * HD;         // [kRows][PAGE]
  float* m_s = ps + kRows * PAGE;     // [kRows]
  float* l_s = m_s + kRows;           // [kRows]
  float* a_s = l_s + kRows;           // [kRows]

  const int d = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = H / KV;
  const int qt = kRows / g;           // positions per tile
  const int t0 = blockIdx.z * qt;
  const int L = lengths[d];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // row r of the tile: head kvh*g + r/qt at position t0 + r%qt
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, e = i % HD;
    const int h = kvh * g + r / qt, t = t0 + r % qt;
    qs[i] = to_f(q[((size_t(d) * S + t) * H + h) * HD + e]) * scale;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int n_pages_d = (L + PAGE - 1) / PAGE;
  int j_hi = min(n_pages_d, (t0 + qt - 1) / PAGE + 1);
  const int j_lo = window > 0 ? max(0, t0 - window + 1) / PAGE : 0;
  if (t0 >= L) j_hi = j_lo;

  float acc[VROWS];
#pragma unroll
  for (int i = 0; i < VROWS; ++i) acc[i] = 0.f;
  const int vcol = tid % HD;
  const int vgrp = tid / HD;
  const int lcol = tid % PAGE;
  const int lgrp = tid / PAGE;
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const int pid = page_tbl[size_t(d) * (S / PAGE) + j];
    const T* kb = kv_pages + ((size_t(pid) * 2 + 0) * KV + kvh) * (size_t(PAGE) * HD);
    const T* vb = kv_pages + ((size_t(pid) * 2 + 1) * KV + kvh) * (size_t(PAGE) * HD);
    for (int i = tid; i < PAGE * HD; i += kThreads) {
      const int c = i / HD, e = i % HD;
      ks[c * KSTRIDE + e] = to_f(kb[i]);
      vs[i] = to_f(vb[i]);
    }
    __syncthreads();

    // logits: thread (lcol, lgrp) computes rows lgrp + LGROUPS*i at key lcol
    float s[LROWS];
#pragma unroll
    for (int i = 0; i < LROWS; ++i) s[i] = 0.f;
    const float* krow = ks + lcol * KSTRIDE;
#pragma unroll 4
    for (int e = 0; e < HD; ++e) {
      const float kv = krow[e];
#pragma unroll
      for (int i = 0; i < LROWS; ++i) s[i] = fmaf(qs[(lgrp + LGROUPS * i) * HD + e], kv, s[i]);
    }
#pragma unroll
    for (int i = 0; i < LROWS; ++i) {
      float x = s[i];
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      const int r = lgrp + LGROUPS * i;
      const int t = t0 + r % qt;
      ps[r * PAGE + lcol] = visible(t, j * PAGE + lcol, L, window) ? x : kNegInf;
    }
    __syncthreads();

    // online softmax: warp w folds rows w, w+8, w+16, w+24
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const int t = t0 + r % qt;
      float x[CPL];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        x[u] = ps[r * PAGE + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u;
        const float p = visible(t, j * PAGE + c, L, window) ? expf(x[u] - m_new) : 0.f;
        ps[r * PAGE + c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r][vcol] = acc * alpha + sum_c p[r][c] * V[c][vcol]
#pragma unroll
    for (int i = 0; i < VROWS; ++i) acc[i] *= a_s[vgrp + VGROUPS * i];
#pragma unroll 4
    for (int c = 0; c < PAGE; ++c) {
      const float v = vs[c * HD + vcol];
#pragma unroll
      for (int i = 0; i < VROWS; ++i) acc[i] = fmaf(ps[(vgrp + VGROUPS * i) * PAGE + c], v, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < VROWS; ++i) {
    const int r = vgrp + VGROUPS * i;
    const float l = l_s[r];
    const float o = l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f;
    const int h = kvh * g + r / qt, t = t0 + r % qt;
    out[((size_t(d) * S + t) * H + h) * HD + vcol] = from_f<T>(o);
  }
}

template <typename T, int HD, int PAGE>
int launch(const void* q, const void* kv, const void* tbl, const void* lens, void* out, int D,
           int S, int H, int KV, float scale, float softcap, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, PAGE>();
  auto kern = rpa_kernel<T, HD, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int qt = kRows / (H / KV);
  dim3 grid(D, KV, S / qt);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int*>(tbl),
      static_cast<const int*>(lens), static_cast<T*>(out), S, H, KV, scale, softcap, window);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kv, const void* tbl, const void* lens, void* out, int D,
             int S, int H, int KV, int hd, int page, float scale, float softcap, int window,
             cudaStream_t st) {
  if (hd == 256 && page == 64) return launch<T, 256, 64>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 256 && page == 32) return launch<T, 256, 32>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 64) return launch<T, 128, 64>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 32) return launch<T, 128, 32>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rpa_launch(const void* q, const void* kv_pages, const void* page_tbl,
                          const void* lengths, void* out, int D, int S, int H, int KV, int hd,
                          int page, int is_bf16, float scale, float softcap, int window,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, kv_pages, page_tbl, lengths, out, D, S, H, KV, hd, page,
                                   scale, softcap, window, st);
  return dispatch<float>(q, kv_pages, page_tbl, lengths, out, D, S, H, KV, hd, page, scale,
                         softcap, window, st);
}

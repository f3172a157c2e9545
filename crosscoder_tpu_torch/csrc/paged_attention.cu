// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/paged_attention.py
// `_rpa_kernel` (reached through `_rpa_call` / `paged_attention`): per
// document, causal (+ sliding-window) attention with logit softcap and GQA,
// reading K/V only from the document's own ceil(len/page) pages of a page
// pool through a page table, folded with an online softmax.
//
// The TPU kernel walks its page loop as a sequential grid axis and keeps a
// whole document's query block in VMEM. Hopper blocks run in no order and
// have 227 KB of shared memory, so here a block owns one query tile of one
// (document, KV head) and loops over the pages its rows can see: from the
// first page inside the window to the last page at or before both the
// tile's last position and the length. A tile's rows are the g query heads
// of the KV head times (tile rows / g) positions. Each block reads its own
// page-table row and length (no scalar prefetch). Probabilities are masked
// explicitly (p = 0 where the mask is false), as in the TPU kernel, so a
// fully masked page cannot add exp(0) = 1; rows whose denominator is 0 are
// written as 0; a tile that starts at or after the length only writes its
// zeros (every caller discards those rows). Two kernels, by dtype:
//
// bf16, rpa_tc_kernel: the products on the tensor cores. A block is 4
// warps and 64 query rows, 16 a warp. The tile's Q, scaled in f32 and
// rounded to bf16 as the reference's `q * scale` is, sits in shared memory;
// each visible page's K and V ([PAGE, hd] bf16, contiguous in the pool) are
// staged by cp.async into a ring of 2 stages, so page j + 1 loads while page
// j multiplies. S = Q.K^T with mma.sync m16n8k16 (bf16 in, fp32 sums; A
// from ldmatrix of Q, B from ldmatrix of the K page, which is K-major as
// stored); softcap, the causal, window and length masks and the online
// softmax (m, l) in fp32 registers; P rounded to bf16 in registers is the A
// operand of O += P.V (B from ldmatrix.trans of the V page, which is
// MN-major as stored), O in fp32 registers (hd / 2 a thread). Rows of 16
// bytes are XOR-swizzled in shared memory so that each ldmatrix hits 32
// distinct banks. The grid walks the tiles latest positions first, so the
// tiles with the most pages start first.
//
// f32, rpa_kernel: the CUDA cores (a tensor-core f32 product is TF32, and
// the f32 bar of 1e-5 rules it out): 32 query rows a block; a page's K and
// V are staged in shared memory as fp32 (K rows padded by one word so the
// per-column dot products hit 32 distinct banks), logits and the online-
// softmax state are fp32, the accumulator lives in registers: thread
// (column d, row group) owns acc[rows][d]. Shared memory at head_dim 256,
// page 64: q 32 KB + K 64.3 KB + V 64 KB + p 8 KB = 169 KB.
//
// Bound. At the serve shapes (8 docs x 1024 tokens, 8 heads / 4 KV heads,
// head_dim 256, bf16) the function moves Q, K, V and O once: about 100 MB
// at full length, 30 us at 3.35 TB/s, against about 34 GFLOP of causal
// QK^T and PV, 35 us at the bf16 tensor-core peak. The bf16 kernel puts
// both products on the tensor cores; it re-reads each visible page once a
// query tile, mostly from L2 (the pool of 8 documents is 34 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;  // the JAX package's NEG_INF
constexpr int kThreads = 256;
constexpr int kRows = 32;  // query rows per block

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kTcRows = 64;        // query rows a block: 4 warps x 16
constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of rows of HD bf16,
// the chunk index XOR-ed with the row's low 3 bits: the 8 rows an
// ldmatrix reads at one logical chunk land in 8 distinct 16-byte slots.
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD, int PAGE>
constexpr size_t tc_smem_bytes() {
  return size_t(kTcRows) * HD * 2 + size_t(4) * PAGE * HD * 2;   // Q, then 2 stages of K and V
}

template <int HD, int PAGE>
__global__ void __launch_bounds__(kTcThreads)
rpa_tc_kernel(const __nv_bfloat16* __restrict__ q,         // [D, S, H, HD]
              const __nv_bfloat16* __restrict__ kv_pages,  // [P, 2, KV, PAGE, HD]
              const int* __restrict__ page_tbl,            // [D, S / PAGE]
              const int* __restrict__ lengths,             // [D]
              __nv_bfloat16* __restrict__ out,             // [D, S, H, HD]
              int S, int H, int KV, float scale, float softcap, int window) {
  constexpr int CH = HD / 8;                     // 16-byte chunks a row
  constexpr int PB = PAGE * HD * 2;              // bytes of a K or V page
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t sq = smem_u32(smem_tc);            // [kTcRows][HD], swizzled
  const uint32_t sk0 = sq + kTcRows * HD * 2;    // stage s: K at sk0 + 2 s PB, V PB further

  const int d = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV, qt = kTcRows / g;        // positions a tile
  const int t0 = (gridDim.z - 1 - blockIdx.z) * qt;
  const int L = lengths[d];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int n_pages_d = (L + PAGE - 1) / PAGE;
  const int j_lo = window > 0 ? max(0, t0 - window + 1) / PAGE : 0;
  const int j_hi = t0 >= L ? j_lo : min(n_pages_d, (min(t0 + qt, S) - 1) / PAGE + 1);
  const size_t row_stride = size_t(H) * HD;      // elements between positions

  if (j_hi <= j_lo) {                            // past the length: zeros
    for (int i = tid; i < kTcRows * CH; i += kTcThreads) {
      const int r = i / CH, c = i % CH, t = t0 + r % qt;
      if (t < S)
        *reinterpret_cast<uint4*>(out + (size_t(d) * S + t) * row_stride +
                                  size_t(kvh * g + r / qt) * HD + c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  auto load_page = [&](int j, int st) {
    const int pid = page_tbl[size_t(d) * (S / PAGE) + j];
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(
        kv_pages + (size_t(pid) * 2 * KV + kvh) * (size_t(PAGE) * HD));
    const unsigned char* vb = kb + size_t(KV) * PB;
    const uint32_t dk = sk0 + st * 2 * PB, dv = dk + PB;
    for (int i = tid; i < PAGE * CH; i += kTcThreads) {
      const int r = i / CH, c = i % CH;
      cp_async16(dk + swz<HD>(r, c), kb + size_t(i) * 16);
      cp_async16(dv + swz<HD>(r, c), vb + size_t(i) * 16);
    }
    cp_async_commit();
  };
  load_page(j_lo, 0);

  // Q, scaled in f32 and rounded to bf16 (rows past S zero)
  for (int i = tid; i < kTcRows * CH; i += kTcThreads) {
    const int r = i / CH, c = i % CH, t = t0 + r % qt;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (size_t(d) * S + t) * row_stride + size_t(kvh * g + r / qt) * HD + c * 8);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(h2[u]);
        w[u] = pack_bf16(f.x * scale, f.y * scale);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    *reinterpret_cast<uint4*>(smem_tc + swz<HD>(r, c)) = v;
  }

  // this thread's two rows of the warp's 16: r and r + 8 (mma fragment rows)
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = warp * 16 + gq, rb = ra + 8;
  const int ta = t0 + ra % qt, tb = t0 + rb % qt;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix: this lane's matrix and row

  for (int j = j_lo; j < j_hi; ++j) {
    const int st = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      load_page(j + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sk = sk0 + st * 2 * PB, sv = sk + PB;

    // S = Q . K^T: 16 rows x PAGE keys a warp
    float s[PAGE / 8][4];
#pragma unroll
    for (int n = 0; n < PAGE / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sq + swz<HD>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < PAGE / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sk + swz<HD>(np * 16 + (mi >> 1) * 8 + mr, kk * 2 + (mi & 1)));
        mma16816(s[2 * np], a, b[0], b[1]);
        mma16816(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // softcap, masks, online softmax (fp32); a quad of lanes shares a row
    float xa = kNegInf, xb = kNegInf;
#pragma unroll
    for (int n = 0; n < PAGE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const int kpos = j * PAGE + n * 8 + 2 * tq + (e & 1);
        x = visible(e < 2 ? ta : tb, kpos, L, window) ? x : kNegInf;
        s[n][e] = x;
        if (e < 2) xa = fmaxf(xa, x);
        else xb = fmaxf(xb, x);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, o_));
      xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, o_));
    }
    const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
    const float aa = expf(ma - na), ab = expf(mb - nb);
    ma = na;
    mb = nb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int n = 0; n < PAGE / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = j * PAGE + n * 8 + 2 * tq + (e & 1);
        const bool a_row = e < 2;
        const float p =
            visible(a_row ? ta : tb, kpos, L, window) ? expf(s[n][e] - (a_row ? na : nb)) : 0.f;
        s[n][e] = p;
        if (a_row) sa += p;
        else sb += p;
      }
    }
    la = la * aa + sa;                           // per-lane partial sums; the quad's at the end
    lb = lb * ab + sb;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= aa;
      o[n][1] *= aa;
      o[n][2] *= ab;
      o[n][3] *= ab;
    }

    // O += P . V: P's fragments are the A operand as they stand
#pragma unroll
    for (int kk = 0; kk < PAGE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, sv + swz<HD>(kk * 16 + (mi & 1) * 8 + mr, np * 2 + (mi >> 1)));
        mma16816(o[2 * np], a, b[0], b[1]);
        mma16816(o[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                             // the stage is free for page j + 2
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o_);
    lb += __shfl_xor_sync(0xffffffffu, lb, o_);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra, t = half ? tb : ta;
    const float l = half ? lb : la;
    if (t >= S) continue;
    __nv_bfloat16* orow = out + (size_t(d) * S + t) * row_stride + size_t(kvh * g + r / qt) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float v0 = l > 0.f ? o[n][2 * half] / fmaxf(l, 1e-30f) : 0.f;
      const float v1 = l > 0.f ? o[n][2 * half + 1] / fmaxf(l, 1e-30f) : 0.f;
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tq) = pack_bf16(v0, v1);
    }
  }
}

template <int HD, int PAGE>
int launch_tc(const void* q, const void* kv, const void* tbl, const void* lens, void* out, int D,
              int S, int H, int KV, float scale, float softcap, int window, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<HD, PAGE>();
  auto kern = rpa_tc_kernel<HD, PAGE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int qt = kTcRows / (H / KV);
  dim3 grid(D, KV, (S + qt - 1) / qt);
  kern<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
      static_cast<const int*>(tbl), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), S, H, KV, scale, softcap, window);
  return int(cudaGetLastError());
}

// by (hd, page): the bf16 tensor-core kernel or the f32 CUDA-core one
template <bool kBf16, int HD, int PAGE>
int launch_any(const void* q, const void* kv, const void* tbl, const void* lens, void* out,
               int D, int S, int H, int KV, float scale, float softcap, int window,
               cudaStream_t st) {
  if constexpr (kBf16)
    return launch_tc<HD, PAGE>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  else
    return launch<float, HD, PAGE>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
}

template <bool kBf16>
int dispatch(const void* q, const void* kv, const void* tbl, const void* lens, void* out, int D,
             int S, int H, int KV, int hd, int page, float scale, float softcap, int window,
             cudaStream_t st) {
  if (hd == 256 && page == 64) return launch_any<kBf16, 256, 64>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 256 && page == 32) return launch_any<kBf16, 256, 32>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 64) return launch_any<kBf16, 128, 64>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 32) return launch_any<kBf16, 128, 32>(q, kv, tbl, lens, out, D, S, H, KV, scale, softcap, window, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rpa_launch(const void* q, const void* kv_pages, const void* page_tbl,
                          const void* lengths, void* out, int D, int S, int H, int KV, int hd,
                          int page, int is_bf16, float scale, float softcap, int window,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true>(q, kv_pages, page_tbl, lengths, out, D, S, H, KV, hd, page, scale,
                          softcap, window, st);
  return dispatch<false>(q, kv_pages, page_tbl, lengths, out, D, S, H, KV, hd, page, scale,
                         softcap, window, st);
}

// Ragged paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/paged_attention.py
// `_rpa_kernel` (reached through `_rpa_call` / `paged_attention`): per
// document, causal (+ sliding-window) attention with logit softcap and GQA,
// reading K/V only from the document's own ceil(len/page) pages, folded
// with an online softmax.
//
// The TPU kernel DMAs pages out of a page pool through a page table and
// walks its page loop as a sequential grid axis, a whole document's query
// block in VMEM. Here the table is the identity (page j of document d is
// rows [j page, (j + 1) page) of k[d] and v[d]), so both kernels read K and
// V where they lie, [D, S, KV, hd], and no pool is built. Hopper blocks run
// in no order and have 227 KB of shared memory, so a block owns one query
// tile of one (document, KV head) and loops over the pages its rows can
// see: from the first page inside the window to the last page at or before
// both the tile's last position and the length. Each block reads its own
// length (no scalar prefetch). Probabilities are masked explicitly (p = 0
// where the mask is false), as in the TPU kernel, so a fully masked page
// cannot add exp(0) = 1; rows whose denominator is 0 are written as 0; a
// tile that starts at or after the length only writes its zeros (every
// caller discards those rows). The grid walks the tiles latest positions
// first, so the tiles with the most pages start first. Two kernels, by
// dtype:
//
// bf16, rpa_wg_kernel: warp-specialized on wgmma and TMA. A tile is 128
// query rows, (128 / g) positions x the g query heads of the KV head,
// position-major (row r: position t0 + r / g, head kvh g + r % g), which is
// the order a TMA box over q [D, S, H, hd] delivers. A block is three
// warpgroups. One thread of the first (the producer, its registers given
// up with setmaxnreg) loads the tile's Q (64-column boxes, 128-byte
// swizzle; rows past S arrive as zeros) and then each visible page's K and
// V, read in place through 4-D tensor maps, into a ring of stages of (K
// page, V page) with full and empty mbarriers. The other two warpgroups
// (the consumers) take 64 rows each: they scale their rows of Q in shared
// memory in f32 and round to bf16, as the reference's `q * scale` is; per
// page, S = Q.K^T by wgmma m64 n`page` k16 with both operands in shared
// memory (K is K-major as stored); softcap, the causal, window and length
// masks and the online softmax (m, l) in f32 registers; then O += P.V by
// wgmma m64n128k16 with P, rounded to bf16, as the register A operand and
// the V page as B, MN-major as stored (the instruction's transpose bit), O
// in f32 registers (hd / 2 a thread). The two warpgroups' products and
// softmaxes interleave on the SM. The epilogue writes O / l in bf16 over
// the warpgroup's rows of Q (same swizzle) and stores it with one TMA box
// a 64 columns, which skips rows past S.
//
// f32, rpa_kernel: the CUDA cores (a tensor-core f32 product is TF32, and
// the f32 bar of 1e-5 rules it out): 32 query rows a block; a page's K and
// V are staged in shared memory as fp32, 16 bytes a load (K rows padded by
// one word so the per-column dot products hit 32 distinct banks), logits
// and the online-softmax state are fp32, the accumulator lives in
// registers: thread (column d, row group) owns acc[rows][d]. Shared memory
// at head_dim 256, page 64: q 32 KB + K 64.3 KB + V 64 KB + p 8 KB = 169 KB.
//
// Bound. At the serve shapes (8 docs x 1024 tokens, 8 heads / 4 KV heads,
// head_dim 256, bf16) the function moves Q, K, V and O once: about 100 MB
// at full length, 30 us at 3.35 TB/s, against about 34 GFLOP of causal
// QK^T and PV, 35 us at the bf16 tensor-core peak. The bf16 kernel puts
// both products on the tensor cores; it re-reads each visible page once a
// query tile, mostly from L2 (K and V of 8 documents are 34 MB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile_sm90.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;  // the JAX package's NEG_INF
constexpr int kThreads = 256;
constexpr int kRows = 32;  // query rows per block

__device__ __forceinline__ bool visible(int t, int kpos, int L, int window) {
  return kpos <= t && kpos < L && (window == 0 || t - kpos < window);
}

template <int HD, int PAGE>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(kRows) * HD + size_t(PAGE) * (HD + 1) + size_t(PAGE) * HD +
          size_t(kRows) * PAGE + 3 * kRows);
}

template <int HD, int PAGE>
__global__ void __launch_bounds__(kThreads)
rpa_kernel(const float* __restrict__ q,        // [D, S, H, HD]
           const float* __restrict__ k,        // [D, S, KV, HD]
           const float* __restrict__ v,        // [D, S, KV, HD]
           const int* __restrict__ lengths,    // [D]
           float* __restrict__ out,            // [D, S, H, HD]
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
    qs[i] = q[((size_t(d) * S + t) * H + h) * HD + e] * scale;
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
  const size_t key_stride = size_t(KV) * HD;     // elements between positions of k and v
  constexpr int V4 = HD / 4, RPASS = kThreads / V4;   // page staging: float4s a row, rows a pass
  const int e4 = (tid % V4) * 4;
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const float* kb = k + (size_t(d) * S + size_t(j) * PAGE) * key_stride + size_t(kvh) * HD;
    const float* vb = v + (kb - k);
    // 16 bytes a thread (the wrapper aligns k and v to 16 bytes): loaded
    // element by element, the page's rows (KV hd apart) made the kernel 1.4x
    // slower than one reading a contiguous pool page
#pragma unroll 4
    for (int c = tid / V4; c < PAGE; c += RPASS) {
      const float4 kx = __ldg(reinterpret_cast<const float4*>(kb + c * key_stride + e4));
      const float4 vx = __ldg(reinterpret_cast<const float4*>(vb + c * key_stride + e4));
      float* kd = ks + c * KSTRIDE + e4;
      kd[0] = kx.x;
      kd[1] = kx.y;
      kd[2] = kx.z;
      kd[3] = kx.w;
      *reinterpret_cast<float4*>(vs + c * HD + e4) = vx;
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
      const float vv = vs[c * HD + vcol];
#pragma unroll
      for (int i = 0; i < VROWS; ++i) acc[i] = fmaf(ps[(vgrp + VGROUPS * i) * PAGE + c], vv, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < VROWS; ++i) {
    const int r = vgrp + VGROUPS * i;
    const float l = l_s[r];
    const float o = l > 0.f ? acc[i] / fmaxf(l, 1e-30f) : 0.f;
    const int h = kvh * g + r / qt, t = t0 + r % qt;
    out[((size_t(d) * S + t) * H + h) * HD + vcol] = o;
  }
}

template <int HD, int PAGE>
int launch_f32(const void* q, const void* k, const void* v, const void* lens, void* out, int D,
               int S, int H, int KV, float scale, float softcap, int window,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, PAGE>();
  auto kern = rpa_kernel<HD, PAGE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int qt = kRows / (H / KV);
  dim3 grid(D, KV, S / qt);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), S, H, KV, scale, softcap, window);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialized wgmma kernel

using etile::desc;
using etile::kWG;
using etile::mbar_arrive;
using etile::mbar_expect_tx;
using etile::mbar_init;
using etile::smem_u32;
using etile::wgmma_commit;
using etile::wgmma_fence;
using etile::wgmma_wait;

constexpr int kWgRows = 128;              // query rows a tile: 2 consumer warpgroups x 64
constexpr int kWgThreads = 3 * kWG;       // the producer warpgroup + 2 consumers
constexpr int kQBox = kWgRows * 128;      // one 64-column box of the tile's Q, 16 KB
constexpr int kWgQBox = 64 * 128;         // a consumer's 64 rows of it, 8 KB
constexpr int kSmemCap = 200 * 1024;      // Q + the ring, below the 227 KB a block may take

template <int HD, int PAGE>
struct WgShape {
  static constexpr int kBoxes = HD / 64;                      // 64-column (128-byte) boxes a row
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kPageBox = PAGE * 128;                 // a box of a K or V page
  static constexpr int kPageBytes = kBoxes * kPageBox;
  static constexpr int kFit = (kSmemCap - kQBytes) / (2 * kPageBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;         // 2 at hd 256, page 64; else 4
  static constexpr size_t kSmem =
      etile::kAlign + kQBytes + size_t(kStages) * 2 * kPageBytes + 8 * (1 + 3 * kStages);
  static_assert(kStages >= 2, "the ring needs two stages");
};

// Waits for the phase of `parity` on `bar`. A wait that never ends (a lost
// TMA load) gives up after 2^28 polls and sets `lost`, and the thread's
// later waits give up at once: the block runs to its end and writes its
// rows as NaN instead of hanging the card. (sm90::mbar_wait traps instead;
// any trap in this kernel made ptxas spill the hd 256 consumers and
// serialize their wgmmas, C7512.)
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity, bool& lost) {
  uint32_t done = lost;
  for (uint32_t polls = 0; !done && polls < (1u << 28); ++polls)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  lost |= !done;
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] . B[16 x 32]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int PAGE>
__device__ __forceinline__ void wgmma_qk(float (&d)[PAGE / 2], uint64_t da, uint64_t db) {
  if constexpr (PAGE == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n32(d, da, db);
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]; A in registers (the fragment of
// an m64 accumulator's 16 columns), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// cap * tanh(x / cap) as cap * sign(y) (1 - 2 / (e^{2|y|} + 1)), y = x / cap:
// an absolute error near 1e-6 cap, where tanh.approx.f32's relative 2^-11
// would move a logit by up to 5e-4 cap (0.025 at Gemma-2's cap of 50).
__device__ __forceinline__ float softcap_of(float x, float cap, float inv_cap) {
  const float y = x * inv_cap;
  return copysignf(cap - __fdividef(2.f * cap, __expf(2.f * fabsf(y)) + 1.f), y);
}

template <int HD, int PAGE, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
rpa_wg_kernel(const __grid_constant__ CUtensorMap qm,   // q [D, S, H, HD], boxes [128/g, g, 64]
              const __grid_constant__ CUtensorMap km,   // k [D, S, KV, HD], boxes [PAGE, 1, 64]
              const __grid_constant__ CUtensorMap vm,   // v, as k
              const __grid_constant__ CUtensorMap om,   // out, as q, boxes [64/g, g, 64]
              const int* __restrict__ lengths,          // [D]
              __nv_bfloat16* __restrict__ out,          // [D, S, H, HD]
              int S, int H, int KV, float scale, float softcap, float inv_cap, int window) {
  using Sh = WgShape<HD, PAGE>;
  constexpr int kStages = Sh::kStages;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* sq = etile::align_smem(smem_wg);   // Q: kBoxes boxes [128 rows][128 B]
  unsigned char* ring = sq + Sh::kQBytes;           // stage s: K page at 2 s kPageBytes, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + size_t(kStages) * 2 * Sh::kPageBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int d = blockIdx.x, kvh = blockIdx.y;
  const int g = H / KV, qt = kWgRows / g;            // positions a tile
  const int t0 = (gridDim.z - 1 - blockIdx.z) * qt;
  const int L = lengths[d];
  const int tid = threadIdx.x;

  const int n_pages_d = (L + PAGE - 1) / PAGE;
  const int j_lo = window > 0 ? max(0, t0 - window + 1) / PAGE : 0;
  const int j_hi = t0 >= L ? j_lo : min(n_pages_d, (min(t0 + qt, S) - 1) / PAGE + 1);

  if (j_hi <= j_lo) {                                // past the length: zeros
    constexpr int CH = HD / 8;                       // 16-byte chunks a row
    for (int i = tid; i < kWgRows * CH; i += kWgThreads) {
      const int r = i / CH, c = i % CH, t = t0 + r / g;
      if (t < S)
        *reinterpret_cast<uint4*>(out + ((size_t(d) * S + t) * H + kvh * g + r % g) * HD +
                                  c * 8) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 2);                       // one arrival a consumer warpgroup
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid < kWG) {                                   // the producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      bool lost = false;
      mbar_expect_tx(q_full, Sh::kQBytes);
      for (int c = 0; c < Sh::kBoxes; ++c)
        etile::tma_load_4d(sq + c * kQBox, &qm, q_full, c * 64, kvh * g, t0, d);
      int st = 0;
      uint32_t ph = 0;
      for (int j = j_lo; j < j_hi; ++j) {
        wait_phase(&empty[st], ph ^ 1, lost);
        unsigned char* kd = ring + size_t(st) * 2 * Sh::kPageBytes;
        mbar_expect_tx(&k_full[st], Sh::kPageBytes);
        for (int c = 0; c < Sh::kBoxes; ++c)
          etile::tma_load_4d(kd + c * Sh::kPageBox, &km, &k_full[st], c * 64, kvh, j * PAGE, d);
        mbar_expect_tx(&v_full[st], Sh::kPageBytes);
        for (int c = 0; c < Sh::kBoxes; ++c)
          etile::tma_load_4d(kd + Sh::kPageBytes + c * Sh::kPageBox, &vm, &v_full[st], c * 64,
                             kvh, j * PAGE, d);
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // the warpgroup's index broadcast from lane 0, so that the compiler sees
  // it warp-uniform and keeps the descriptors built from it in uniform
  // registers
  const int cw = __shfl_sync(0xffffffffu, tid / kWG, 0) - 1, t = tid % kWG;
  const int warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int ra = cw * 64 + warp * 16 + gq, rb = ra + 8;   // this thread's two rows of the tile
  const int ta = t0 + ra / g, tb = t0 + rb / g;
  unsigned char* qw = sq + cw * kWgQBox;             // this warpgroup's rows of each Q box
  const uint32_t qa = smem_u32(qw);

  // Q * scale, rounded to bf16, in place (rows past S are TMA's zeros)
  bool lost = false;
  wait_phase(q_full, 0, lost);
  for (int i = t; i < Sh::kBoxes * (kWgQBox / 16); i += kWG) {
    uint4* p = reinterpret_cast<uint4*>(qw + (i / (kWgQBox / 16)) * kQBox +
                                        (i % (kWgQBox / 16)) * 16);
    uint4 raw = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[u]));
      w[u] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = raw;
  }
  etile::fence_proxy_async();
  etile::wg_sync(cw);

  float o[HD / 128][64];
#pragma unroll
  for (int n = 0; n < HD / 128; ++n)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[n][i] = 0.f;
  float ma = kNegInf, mb = kNegInf, la = 0.f, lb = 0.f;
  int st = 0;
  uint32_t ph = 0;

  for (int j = j_lo; j < j_hi; ++j) {
    const uint32_t ka = smem_u32(ring + size_t(st) * 2 * Sh::kPageBytes);
    const uint32_t va = ka + Sh::kPageBytes;
    // descriptors step by their address field (bytes / 16)
    const uint64_t dq = desc(qa, 16, 1024), dk = desc(ka, 16, 1024);
    const uint64_t dv = desc(va, Sh::kPageBox, 1024);

    // S = Q . K^T: 64 rows x PAGE keys, 16 of hd a step (4 steps a box)
    float s[PAGE / 2];
#pragma unroll
    for (int i = 0; i < PAGE / 2; ++i) s[i] = 0.f;
    wait_phase(&k_full[st], ph, lost);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk<PAGE>(s, dq + ((kk >> 2) * kQBox + (kk & 3) * 32) / 16,
                     dk + ((kk >> 2) * Sh::kPageBox + (kk & 3) * 32) / 16);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // softcap, masks, online softmax (fp32). Accumulator i of this thread
    // sits at row ra (i & 2 == 0) or rb and key base + 8 (i / 4) + (i & 1),
    // base = j PAGE + 2 tq; a quad of lanes shares a row. Each row's
    // visible keys are a bit mask over its PAGE / 4 keys (bit 2 (i / 4) +
    // (i & 1)), built against immediates, so no per-key bound lives in a
    // register across the page loop.
    const int base = j * PAGE + 2 * tq;
    auto visible_bits = [&](int t_row) {
      const int hi = min(t_row, L - 1) - base;                  // causal and length
      const int lo = window > 0 ? t_row - window - base : -1;   // the window
      uint32_t bits = 0;
#pragma unroll
      for (int c = 0; c < PAGE / 4; ++c) {
        const int key = 8 * (c >> 1) + (c & 1);
        bits |= uint32_t(key <= hi && key > lo) << c;
      }
      return bits;
    };
    const uint32_t vis_a = visible_bits(ta), vis_b = visible_bits(tb);
    float xa = kNegInf, xb = kNegInf;
#pragma unroll
    for (int i = 0; i < PAGE / 2; ++i) {
      float x = s[i];
      if constexpr (kCap) x = softcap_of(x, softcap, inv_cap);
      const bool row_b = (i >> 1) & 1;
      x = (((row_b ? vis_b : vis_a) >> ((i >> 2) * 2 + (i & 1))) & 1) ? x : kNegInf;
      s[i] = x;
      if (row_b) xb = fmaxf(xb, x);
      else xa = fmaxf(xa, x);
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, o_));
      xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, o_));
    }
    const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
    const float aa = __expf(ma - na), ab = __expf(mb - nb);
    ma = na;
    mb = nb;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int i = 0; i < PAGE / 2; ++i) {
      const bool row_b = (i >> 1) & 1;
      const float p = (((row_b ? vis_b : vis_a) >> ((i >> 2) * 2 + (i & 1))) & 1)
                          ? __expf(s[i] - (row_b ? nb : na)) : 0.f;
      s[i] = p;
      if (row_b) sb += p;
      else sa += p;
    }
    la = la * aa + sa;                               // per-lane partial sums; the quad's at the end
    lb = lb * ab + sb;
#pragma unroll
    for (int n = 0; n < HD / 128; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[n][i] *= ((i >> 1) & 1) ? ab : aa;

    // O += P . V: P's accumulator fragment, in bf16, is the A operand as it
    // stands; V's 16 keys a step are 2 swizzle atoms (2 KB), its 64-column
    // boxes kPageBox apart (the leading byte offset)
    wait_phase(&v_full[st], ph, lost);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PAGE / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
#pragma unroll
      for (int n = 0; n < HD / 128; ++n)
        wgmma_rs_n128(o[n], a, dv + (n * 2 * Sh::kPageBox + kk * 2048) / 16);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < HD / 128; ++n) fence_regs(o[n]);
    if (t == 0) mbar_arrive(&empty[st]);             // the stage is free for the producer
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, o_);
    lb += __shfl_xor_sync(0xffffffffu, lb, o_);
  }
  const float nan = __int_as_float(0x7fc00000);
  const float ia = lost ? nan : la > 0.f ? 1.f / la : 0.f;
  const float ib = lost ? nan : lb > 0.f ? 1.f / lb : 0.f;

  // O / l in bf16 over this warpgroup's rows of Q, in the 128-byte swizzle
  // (16-byte chunk c of row r at chunk c ^ (r & 7)), then one TMA store a box
#pragma unroll
  for (int n = 0; n < HD / 128; ++n)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const bool row_b = (i >> 1) & 1;
      const int rr = warp * 16 + gq + (row_b ? 8 : 0);
      const int col = n * 128 + 8 * (i >> 2) + 2 * tq;
      const float inv = row_b ? ib : ia;
      *reinterpret_cast<uint32_t*>(qw + (col >> 6) * kQBox + rr * 128 +
                                   ((((col & 63) >> 3) ^ (rr & 7)) << 4) + (col & 7) * 2) =
          pack_bf16(o[n][i] * inv, o[n][i + 1] * inv);
    }
  etile::fence_proxy_async();
  etile::wg_sync(cw);
  if (t == 0) {
    for (int c = 0; c < Sh::kBoxes; ++c)
      etile::tma_store_4d(&om, qw + c * kQBox, c * 64, kvh * g, t0 + cw * (qt / 2), d);
    etile::tma_store_drain();
  }
}

// A bf16 tensor [D, S, heads, HD] read (or written) in boxes [rows, box_heads, 64].
int encode_4d(CUtensorMap* map, const void* base, int HD, int heads, int S, int D,
              int box_heads, int box_rows) {
  const uint64_t dims[4] = {uint64_t(HD), uint64_t(heads), uint64_t(S), uint64_t(D)};
  const uint64_t strides[3] = {uint64_t(HD) * 2, uint64_t(heads) * HD * 2,
                               uint64_t(S) * heads * HD * 2};
  const uint32_t box[4] = {64, uint32_t(box_heads), uint32_t(box_rows), 1};
  return etile::encode_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                              CU_TENSOR_MAP_SWIZZLE_128B, base, dims, strides, box);
}

template <int HD, int PAGE, bool kCap>
int launch_wg(const void* q, const void* k, const void* v, const void* lens, void* out, int D,
              int S, int H, int KV, float scale, float softcap, int window,
              cudaStream_t stream) {
  using Sh = WgShape<HD, PAGE>;
  const int g = H / KV;
  if (g < 1 || H % KV || 64 % g) return int(cudaErrorInvalidValue);
  const int qt = kWgRows / g;
  CUtensorMap qm, km, vm, om;
  int e = encode_4d(&qm, q, HD, H, S, D, g, qt);
  if (e == 0) e = encode_4d(&km, k, HD, KV, S, D, 1, PAGE);
  if (e == 0) e = encode_4d(&vm, v, HD, KV, S, D, 1, PAGE);
  if (e == 0) e = encode_4d(&om, out, HD, H, S, D, g, qt / 2);
  if (e != 0) return e;
  auto kern = rpa_wg_kernel<HD, PAGE, kCap>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Sh::kSmem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(D, KV, (S + qt - 1) / qt);
  kern<<<grid, kWgThreads, Sh::kSmem, stream>>>(
      qm, km, vm, om, static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), S, H,
      KV, scale, softcap, kCap ? 1.f / softcap : 0.f, window);
  return int(cudaGetLastError());
}

// by (hd, page): the bf16 wgmma kernel or the f32 CUDA-core one
template <bool kBf16, int HD, int PAGE>
int launch_any(const void* q, const void* k, const void* v, const void* lens, void* out, int D,
               int S, int H, int KV, float scale, float softcap, int window, cudaStream_t st) {
  if constexpr (kBf16) {
    if (softcap != 0.f)
      return launch_wg<HD, PAGE, true>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window,
                                       st);
    return launch_wg<HD, PAGE, false>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window,
                                      st);
  } else {
    return launch_f32<HD, PAGE>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window, st);
  }
}

template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, const void* lens, void* out, int D,
             int S, int H, int KV, int hd, int page, float scale, float softcap, int window,
             cudaStream_t st) {
  if (hd == 256 && page == 64) return launch_any<kBf16, 256, 64>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 256 && page == 32) return launch_any<kBf16, 256, 32>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 64) return launch_any<kBf16, 128, 64>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window, st);
  if (hd == 128 && page == 32) return launch_any<kBf16, 128, 32>(q, k, v, lens, out, D, S, H, KV, scale, softcap, window, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// q [D, S, H, hd], k and v [D, S, KV, hd] (contiguous; bf16 16-byte
// aligned), lengths [D] int32, out [D, S, H, hd] in q's dtype.
extern "C" int rpa_launch(const void* q, const void* k, const void* v, const void* lengths,
                          void* out, int D, int S, int H, int KV, int hd, int page, int is_bf16,
                          float scale, float softcap, int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<true>(q, k, v, lengths, out, D, S, H, KV, hd, page, scale, softcap, window,
                          st);
  return dispatch<false>(q, k, v, lengths, out, D, S, H, KV, hd, page, scale, softcap, window,
                         st);
}

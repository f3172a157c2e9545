// Fused encoder -> BatchTopK for Hopper (sm_90a): the masked activations of
// relu(cast(x . W + b)) that reach the global (k·B)-th largest value of the
// batch, without writing the [B, width] pre-activation matrix to select.
//
// Replaces the Pallas TPU kernels crosscoder_tpu/ops/fused_encoder_topk.py
// `_fused_bt_bisect_kernel` (select) and `_fused_bt_emit_kernel` (emit),
// reached through `fused_batchtopk_encode_raw`.
//
// The TPU kernels walk a sequential grid (passes, row blocks, dictionary
// chunks) that carries 255 bisection counts in SMEM and recomputes each
// pre-activation tile from the product in every pass. Here every pass is a
// persistent grid over [128, 128] output tiles, each tile recomputed from
// the product and never stored; the pass differs only in what it does with
// the tile. Counts are integers added with atomics, so the result does not
// depend on the order the blocks run in:
//   bf16: the product on the tensor cores (encoder_tile_sm90.cuh: TMA ring,
//     two consumer warpgroups of wgmma, fp32 sums); one counting pass. The
//     pattern of each pre-activation (its bf16 bits; K9's rule: sign-set ->
//     0, NaN -> 0x7FFE) is a 15-bit key; each block counts the positive
//     keys of its tiles in a 32768-bin shared histogram (128 KB, beside a
//     3-stage ring of 96 KB), flushes it into a global 64-bit histogram,
//     and the last block (a fence and a ticket) walks the suffix sums to
//     kth, the largest pattern p with count(pattern >= p) >= kk (0 when
//     fewer than kk are positive).
//   f32: the product on the CUDA cores (a tensor-core f32 product would be
//     TF32): x and W staged in shared memory 16 columns of the contraction
//     at a time, an 8 x 8 register tile a thread. Two counting passes over
//     the 31-bit pattern (NaN -> 0x7FFFFFFE): the same histogram over its
//     top 15 bits finds the bin that holds kth, then a pass over the low 16
//     bits of the entries in that bin (global 64-bit atomics, one per
//     distinct bin a warp, __match_any_sync).
//   emit: one more pass writes (pattern >= kth && pattern > 0) ? the value
//     of the pattern : 0 in the compute dtype, so every tie at kth is kept
//     (bf16: each consumer warpgroup stages its 64 rows in shared memory
//     and stores them 16 bytes a thread).
//   count (fused_bt_count, added for the threshold over a rank grid; it
//     replaces no TPU kernel of its own: JAX's GSPMD runs
//     `_fused_bt_bisect_kernel`'s counting pass over the sharded
//     dictionary and sums its counts across devices): one pass over a
//     rank's tiles counting, for T <= 32 candidate patterns
//     mids[j] = lo + 1 + q·j + (rem·j)/T (q, rem = divmod(hi - lo - 1, T),
//     K9's bisection points in [lo, hi)), the entries whose pattern reaches
//     each. An entry adds one to shared bin n-1, n the number of mids it
//     reaches (a 5-step binary search of the mids, staged in shared
//     memory and padded past T with 0xFFFFFFFF, which no pattern reaches);
//     the block adds the bins' suffix sums into the T 64-bit counts. The
//     caller sums the counts over the ranks and narrows [lo, hi) as K9's
//     bisection does.
// Rows past B and columns past width are masked out of every count: a
// positive bias would otherwise make zero rows count (the TPU kernels'
// `_tile_bits` guard).
//
// Bound. At the training shape (x [4096, 4608], W [4608, 32768] bf16) the
// product is 1.24 TFLOP, 1.2507 ms at the bf16 tensor-core peak; the bytes
// (x 38 MB, W 302 MB, f 268 MB) take 0.18 ms. The bound counts the product
// once; this design computes it 2 times in bf16 (on the tensor cores, W
// read about once a pass) and 3 in f32 (on the CUDA cores). A count pass
// is one more product: the same 1.2507 ms bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;          // tile rows
constexpr int kBN = 128;          // tile columns
constexpr int kBK = 16;           // contraction columns staged a step
constexpr int kBins1 = 1 << 15;   // top-15-bit histogram
constexpr int kBins2 = 1 << 16;   // low-16-bit histogram (f32)
constexpr int kMaxMids = 32;      // candidate patterns a count pass takes

enum Mode { kHist1 = 0, kHist2 = 1, kEmit = 2, kCount = 3 };

// a count pass's candidate patterns, ascending, padded past t with 0xFFFFFFFF
struct Mids {
  unsigned v[kMaxMids];
  int t;
};

// The mids of `m` into shared memory `v` (kMaxMids words), by the block.
__device__ __forceinline__ void stage_mids(const Mids& m, unsigned* v) {
  if (threadIdx.x < kMaxMids) v[threadIdx.x] = m.v[threadIdx.x];
}

// Mids reached by pattern p: the count of v[j] <= p over the sorted,
// padded v (0 for p == 0: every mid is >= 1), by binary search.
__device__ __forceinline__ int mids_reached(const unsigned* v, unsigned p) {
  int n = 0;
#pragma unroll
  for (int step = kMaxMids / 2; step > 0; step >>= 1)
    if (v[n + step - 1] <= p) n += step;
  return n + (n == kMaxMids - 1 && v[n] <= p);
}

// The end of a count pass: the block's bins (sbins[n-1]: entries reaching
// exactly n mids) as suffix sums into counts[j] (entries reaching mid j).
__device__ __forceinline__ void flush_counts(const unsigned* sbins, int t,
                                             unsigned long long* counts) {
  __syncthreads();
  if (threadIdx.x < t) {
    unsigned long long c = 0;
    for (int b = threadIdx.x; b < t; ++b) c += sbins[b];
    if (c) atomicAdd(&counts[threadIdx.x], c);
  }
}

// device state, 64-bit words zeroed by the wrapper
struct State {
  unsigned long long hist1[kBins1];
  unsigned long long hist2[kBins2];
  unsigned long long ticket1, ticket2;
  long long prefix, kk2, done;
};

__device__ __forceinline__ unsigned pattern16(unsigned b) {
  if (b & 0x8000u) return b > 0xFF80u ? 0x7FFEu : 0u;
  return b < 0x7FFEu ? b : 0x7FFEu;
}

__device__ __forceinline__ unsigned pattern32(unsigned b) {
  if (b & 0x80000000u) return b > 0xFF800000u ? 0x7FFFFFFEu : 0u;
  return b < 0x7FFFFFFEu ? b : 0x7FFFFFFEu;
}

// 8 consecutive elements from a 32-byte boundary
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// --- f32: the product on the CUDA cores -------------------------------------

// Thread (ty, tx) of a tile owns rows ty*4 + i and 64 + ty*4 + i, and
// columns tx*4 + j and 64 + tx*4 + j (i, j < 4).
__device__ __forceinline__ int tile_row(int ty, int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); }

// acc[i][j] = sum over the contraction of x[row0 + r_i, :] * W[:, c0 + c_j], fp32.
__device__ __forceinline__ void tile_product(const float* __restrict__ x, const float* __restrict__ W,
                                             int B, int nd, int width, int row0, int c0,
                                             float (*As)[kBM], float (*Bs)[kBN],
                                             float acc[8][8]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  // loaders: x rows (tid >> 1), 8 contraction columns at (tid & 1) * 8;
  // W contraction row (tid >> 4), 8 columns at (tid & 15) * 8
  const int xm = tid >> 1, xk = (tid & 1) * 8;
  const int wk = tid >> 4, wc = (tid & 15) * 8;
  const bool x_ok = row0 + xm < B, w_ok = c0 + wc < width;
  const float* xp = x + size_t(row0 + xm) * nd + xk;
  const float* wp = W + size_t(wk) * width + c0 + wc;
  for (int k0 = 0; k0 < nd; k0 += kBK) {
    float v[8];
    if (x_ok) {
      load8(xp + k0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) As[xk + j][xm] = v[j];
    if (w_ok) {
      load8(wp + size_t(k0) * width, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    *reinterpret_cast<float4*>(&Bs[wk][wc]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&Bs[wk][wc + 4]) = make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// --- the end of a counting pass, both dtypes -----------------------------------

// The last block of a counting pass: the largest bin p of hist[0, n_bins)
// whose suffix count reaches kk. Returns p, or -1 when the total is below
// kk; *above gets the count of the bins past p. NT: the block's threads;
// `sums`: NT 64-bit words of shared memory.
template <int NT>
__device__ int suffix_select(const unsigned long long* hist, int n_bins, long long kk,
                             unsigned long long* sums, unsigned long long* above) {
  __shared__ int best;
  constexpr int nt = NT;
  const int t = threadIdx.x, per = (n_bins + nt - 1) / nt;
  const int lo = t * per, hi = min(lo + per, n_bins);
  unsigned long long mine = 0;
  for (int p = lo; p < hi; ++p) mine += __ldcg(&hist[p]);
  if (t == 0) best = -1;
  sums[t] = mine;
  __syncthreads();
  for (int o = 1; o < nt; o <<= 1) {              // inclusive suffix scan
    const unsigned long long add = t + o < nt ? sums[t + o] : 0ull;
    __syncthreads();
    sums[t] += add;
    __syncthreads();
  }
  unsigned long long run = t + 1 < nt ? sums[t + 1] : 0ull;
  int found = -1;
  unsigned long long run_above = 0;
  for (int p = hi - 1; p >= lo; --p) {
    const unsigned long long h = __ldcg(&hist[p]);
    if (run + h >= (unsigned long long)kk) {
      found = p;
      run_above = run;
      break;
    }
    run += h;
  }
  if (found >= 0) atomicMax(&best, found);
  __syncthreads();
  const int b = best;
  if (b >= 0 && found == b) *above = run_above;
  __syncthreads();
  return b;
}

__device__ __forceinline__ bool last_block(unsigned long long* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1ull) == (unsigned long long)(gridDim.x - 1);
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The end of a counting pass: the block's counts into the global
// histogram (pass 1), then the last block to finish picks kth's bin (pass
// 1: kth itself in bf16, its top 15 bits in f32) or its low 16 bits (pass 2).
// NT: the block's threads; `sums`: NT 64-bit words of shared memory.
template <bool kBf16, int MODE, int NT>
__device__ void finish_count(State* st, int* kth_out, long long kk, unsigned prefix,
                             const unsigned* shist, unsigned long long* sums) {
  __shared__ unsigned long long above;
  const int tid = threadIdx.x;
  if constexpr (MODE == kHist1) {
    __syncthreads();
    for (int i = tid; i < kBins1; i += NT)
      if (shist[i]) atomicAdd(&st->hist1[i], (unsigned long long)shist[i]);
    if (!last_block(&st->ticket1)) return;
    const int p = suffix_select<NT>(st->hist1, kBins1, kk, sums, &above);
    if (tid != 0) return;
    if (p < 0) {                      // fewer than kk positives: keep them all
      st->done = 1;
      *kth_out = 0;
    } else if (kBf16) {
      *kth_out = p;
    } else {
      st->prefix = p;
      st->kk2 = kk - (long long)above;
    }
  } else {
    if (!last_block(&st->ticket2)) return;
    const int l = suffix_select<NT>(st->hist2, kBins2, st->kk2, sums, &above);
    if (tid == 0) *kth_out = int((prefix << 16) | unsigned(l < 0 ? 0 : l));
  }
}

// --- f32 passes -------------------------------------------------------------

// One pass of the f32 path over every tile.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
bt_pass(const float* __restrict__ x, const float* __restrict__ W, const float* __restrict__ b,
        State* __restrict__ st, int* __restrict__ kth_out, float* __restrict__ out,
        int B, int nd, int width, long long kk, const Mids mids,
        unsigned long long* __restrict__ counts) {
  extern __shared__ unsigned shist[];          // kHist1: [kBins1]; kCount: bins, then mids
  __shared__ __align__(16) float As[kBK][kBM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, lane = tid & 31;

  unsigned kth = 0, prefix = 0;
  if constexpr (MODE == kHist1 || MODE == kCount) {
    for (int i = tid; i < (MODE == kHist1 ? kBins1 : kMaxMids); i += kThreads) shist[i] = 0;
    if constexpr (MODE == kCount) stage_mids(mids, shist + kMaxMids);
    __syncthreads();
  } else if constexpr (MODE == kHist2) {
    if (st->done) return;
    prefix = unsigned(st->prefix);
  } else {
    kth = unsigned(*kth_out);
  }

  const int n_rb = (B + kBM - 1) / kBM;
  const int n_tiles = n_rb * ((width + kBN - 1) / kBN);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = (t % n_rb) * kBM, c0 = (t / n_rb) * kBN;
    float acc[8][8];
    tile_product(x, W, B, nd, width, row0, c0, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + tile_row(ty, i);
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        const int c = c0 + jh * 64 + tx * 4;
        const bool ok = r < B && c < width;     // width % 8 == 0: 4 columns in or out together
        unsigned p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = ok ? pattern32(__float_as_uint(acc[i][jh * 4 + j] + b[c + j])) : 0u;
        if constexpr (MODE == kHist1) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (p[j]) atomicAdd(&shist[p[j] >> 16], 1u);
        } else if constexpr (MODE == kCount) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = mids_reached(shist + kMaxMids, p[j]);
            if (n) atomicAdd(&shist[n - 1], 1u);
          }
        } else if constexpr (MODE == kHist2) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = p[j] != 0u && (p[j] >> 16) == prefix;
            const unsigned key = in ? (p[j] & 0xFFFFu) : 0xFFFFFFFFu;
            const unsigned peers = __match_any_sync(0xffffffffu, key);
            if (in && lane == __ffs(peers) - 1)
              atomicAdd(&st->hist2[key], (unsigned long long)__popc(peers));
          }
        } else {
          if (!ok) continue;
          unsigned v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = p[j] >= kth && p[j] > 0u ? p[j] : 0u;
          *reinterpret_cast<uint4*>(reinterpret_cast<unsigned*>(out) + size_t(r) * width + c) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
  if constexpr (MODE == kCount) {
    flush_counts(shist, mids.t, counts);
  } else if constexpr (MODE != kEmit) {
    __shared__ unsigned long long sums[kThreads];
    finish_count<false, MODE, kThreads>(st, kth_out, kk, prefix, shist, sums);
  }
}

// --- bf16 on the tensor-core tile ------------------------------------------

constexpr int kSelStages = 3;                // 96 KB beside the 128 KB histogram
constexpr int kEmitStages = 4;
constexpr int kOutPitch = etile::kBN / 2 + 4;   // 32-bit words a staged bf16 row: conflict-free

__device__ __forceinline__ unsigned pattern_bf16(float h) {
  return pattern16(__bfloat16_as_ushort(__float2bfloat16_rn(h)));
}

struct SelectEpilogue {
  const float* b;
  unsigned* shist;
  int B, width;

  __device__ __forceinline__ void operator()(float (&acc)[64], int row0, int c0, int cw, int t) {
    const int rbase = row0 + cw * 64;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = etile::frag_row(i, t), c = etile::frag_col(i, t);
      if (rbase + r < B && c0 + c < width) {    // width % 8 == 0: c and c + 1 in or out together
        const float2 bb = *reinterpret_cast<const float2*>(b + c0 + c);
        const unsigned p0 = pattern_bf16(acc[i] + bb.x), p1 = pattern_bf16(acc[i + 1] + bb.y);
        if (p0) atomicAdd(&shist[p0], 1u);
        if (p1) atomicAdd(&shist[p1], 1u);
      }
    }
  }
};

struct EmitEpilogue {
  const float* b;
  unsigned kth;
  uint16_t* out;
  uint32_t* staged;   // [kBM][kOutPitch]
  int B, width;

  __device__ __forceinline__ void operator()(float (&acc)[64], int row0, int c0, int cw, int t) {
    uint32_t* sw = staged + cw * 64 * kOutPitch;
    const int rbase = row0 + cw * 64;
    etile::wg_sync(cw);                         // the previous tile's stores are done with sw
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = etile::frag_row(i, t), c = etile::frag_col(i, t);
      unsigned v0 = 0, v1 = 0;
      if (rbase + r < B && c0 + c < width) {
        const float2 bb = *reinterpret_cast<const float2*>(b + c0 + c);
        v0 = pattern_bf16(acc[i] + bb.x);
        v1 = pattern_bf16(acc[i + 1] + bb.y);
        v0 = v0 >= kth && v0 > 0u ? v0 : 0u;
        v1 = v1 >= kth && v1 > 0u ? v1 : 0u;
      }
      sw[r * kOutPitch + (c >> 1)] = v0 | (v1 << 16);
    }
    etile::wg_sync(cw);
    // 64 rows x 16 chunks of 8 columns, 16 bytes a store
    for (int q = t; q < 64 * (etile::kBN / 8); q += etile::kWG) {
      const int r = q >> 4, ch = q & 15, gc = c0 + ch * 8;
      if (rbase + r < B && gc < width)
        *reinterpret_cast<uint4*>(out + size_t(rbase + r) * width + gc) =
            *reinterpret_cast<const uint4*>(sw + r * kOutPitch + ch * 4);
    }
  }
};

struct CountEpilogue {
  const float* b;
  const unsigned* mids;   // staged in shared memory
  unsigned* sbins;
  int B, width;

  __device__ __forceinline__ void operator()(float (&acc)[64], int row0, int c0, int cw, int t) {
    const int rbase = row0 + cw * 64;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = etile::frag_row(i, t), c = etile::frag_col(i, t);
      if (rbase + r < B && c0 + c < width) {
        const float2 bb = *reinterpret_cast<const float2*>(b + c0 + c);
        const int n0 = mids_reached(mids, pattern_bf16(acc[i] + bb.x));
        const int n1 = mids_reached(mids, pattern_bf16(acc[i + 1] + bb.y));
        if (n0) atomicAdd(&sbins[n0 - 1], 1u);
        if (n1) atomicAdd(&sbins[n1 - 1], 1u);
      }
    }
  }
};

constexpr size_t kSelSmem = size_t(kBins1) * sizeof(unsigned) + etile::ring_bytes(kSelStages) +
                            etile::kAlign;
constexpr size_t kCountSmem = etile::ring_bytes(kEmitStages) + etile::kAlign;
constexpr size_t kEmitSmem = etile::ring_bytes(kEmitStages) +
                             size_t(etile::kBM) * kOutPitch * sizeof(uint32_t) + etile::kAlign;

__global__ void __launch_bounds__(etile::kThreads, 1)
bt_select_tc(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
             const float* __restrict__ b, State* __restrict__ st, int* __restrict__ kth_out, int B,
             int nd, int width, long long kk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* shist = reinterpret_cast<unsigned*>(smem_raw);
  unsigned char* ring = etile::align_smem(smem_raw + size_t(kBins1) * sizeof(unsigned));
  for (int i = threadIdx.x; i < kBins1; i += blockDim.x) shist[i] = 0;
  SelectEpilogue epi{b, shist, B, width};
  etile::run_tiles<kSelStages>(&xm, &wm, ring, B, nd, width, epi);   // syncs after the zeroing
  // the ring is dead once every block thread is past finish_count's first barrier
  finish_count<true, kHist1, etile::kThreads>(st, kth_out, kk, 0, shist,
                                              reinterpret_cast<unsigned long long*>(ring));
}

__global__ void __launch_bounds__(etile::kThreads, 1)
bt_count_tc(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
            const float* __restrict__ b, const __grid_constant__ Mids mids,
            unsigned long long* __restrict__ counts, int B, int nd, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned sbins[kMaxMids], smids[kMaxMids];
  unsigned char* ring = etile::align_smem(smem_raw);
  if (threadIdx.x < kMaxMids) sbins[threadIdx.x] = 0;
  stage_mids(mids, smids);
  CountEpilogue epi{b, smids, sbins, B, width};
  etile::run_tiles<kEmitStages>(&xm, &wm, ring, B, nd, width, epi);   // syncs after the zeroing
  flush_counts(sbins, mids.t, counts);
}

__global__ void __launch_bounds__(etile::kThreads, 1)
bt_emit_tc(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
           const float* __restrict__ b, const int* __restrict__ kth, uint16_t* __restrict__ out,
           int B, int nd, int width) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = etile::align_smem(smem_raw);
  EmitEpilogue epi{b, unsigned(*kth), out,
                   reinterpret_cast<uint32_t*>(ring + etile::ring_bytes(kEmitStages)), B, width};
  etile::run_tiles<kEmitStages>(&xm, &wm, ring, B, nd, width, epi);
}

// --- f32 launches ----------------------------------------------------------

template <int MODE>
int launch_pass(const void* x, const void* W, const void* b, void* st, void* kth, void* out, int B,
                int nd, int width, long long kk, cudaStream_t stream, const Mids& mids = Mids{},
                void* counts = nullptr) {
  auto kern = bt_pass<MODE>;
  const size_t smem = MODE == kHist1   ? kBins1 * sizeof(unsigned)
                      : MODE == kCount ? 2 * kMaxMids * sizeof(unsigned)
                                       : 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return int(e);
  const long long n_tiles =
      (long long)((B + kBM - 1) / kBM) * ((width + kBN - 1) / kBN);
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * etile::sm_count();
  if (grid > n_tiles) grid = n_tiles;
  kern<<<int(grid), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(W), static_cast<const float*>(b),
      static_cast<State*>(st), static_cast<int*>(kth), static_cast<float*>(out), B, nd, width, kk,
      mids, static_cast<unsigned long long*>(counts));
  return int(cudaGetLastError());
}

int run_select_f32(const void* x, const void* W, const void* b, void* st, void* kth, int B, int nd,
                   int width, long long kk, cudaStream_t stream) {
  int e = launch_pass<kHist1>(x, W, b, st, kth, nullptr, B, nd, width, kk, stream);
  if (e != 0) return e;
  return launch_pass<kHist2>(x, W, b, st, kth, nullptr, B, nd, width, kk, stream);
}

}  // namespace

extern "C" long long fused_bt_state_bytes() { return (long long)sizeof(State); }

// `state`: fused_bt_state_bytes() zeroed bytes; `kth`: one int32, written.
extern "C" int fused_bt_select(const void* x, const void* W, const void* b, void* state, void* kth,
                               int B, int nd, int width, long long kk, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return etile::launch(bt_select_tc, kSelSmem, x, W, B, nd, width, st,
                         static_cast<const float*>(b), static_cast<State*>(state),
                         static_cast<int*>(kth), B, nd, width, kk);
  return run_select_f32(x, W, b, state, kth, B, nd, width, kk, st);
}

// `counts`: t zeroed 64-bit words, counts[j] += the entries whose pattern
// reaches mids[j] (the bisection points of [lo, hi), lo < hi - 1); t in
// [1, 32].
extern "C" int fused_bt_count(const void* x, const void* W, const void* b, void* counts, int B,
                              int nd, int width, int lo, int hi, int t, int is_bf16,
                              void* stream) {
  if (t < 1 || t > kMaxMids || lo < 0 || hi - lo < 2) return int(cudaErrorInvalidValue);
  Mids mids{};
  mids.t = t;
  const long long span = (long long)hi - lo - 1, q = span / t, rem = span % t;
  for (int j = 0; j < kMaxMids; ++j)
    mids.v[j] = j < t ? unsigned(lo + 1 + q * j + (rem * j) / t) : 0xFFFFFFFFu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return etile::launch(bt_count_tc, kCountSmem, x, W, B, nd, width, st,
                         static_cast<const float*>(b), mids,
                         static_cast<unsigned long long*>(counts), B, nd, width);
  return launch_pass<kCount>(x, W, b, nullptr, nullptr, nullptr, B, nd, width, 0, st, mids,
                             counts);
}

extern "C" int fused_bt_emit(const void* x, const void* W, const void* b, const void* kth,
                             void* out, int B, int nd, int width, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return etile::launch(bt_emit_tc, kEmitSmem, x, W, B, nd, width, st,
                         static_cast<const float*>(b), static_cast<const int*>(kth),
                         static_cast<uint16_t*>(out), B, nd, width);
  return launch_pass<kEmit>(x, W, b, nullptr, const_cast<void*>(kth), out, B, nd, width, 0, st);
}

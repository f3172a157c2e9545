// Fused encoder -> TopK with the int8 block-scaled product, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/fused_encoder_topk.py
// `_fused_topk_kernel_q` (reached through `fused_topk_encode(...,
// quant_block=B)`): per row of x, the top-k of relu(cast(acc + b)) where
//   acc = sum over contraction blocks q = 0..nb-1, in that order, of
//         (p_q * xs[row, q]) * ws[q, col],   p_q = sum_{j in q} xq[row, j] * wq[j, col]
// with xq / wq the int8 block-scaled operands (per (row, block) and per
// (block, column) scales, ops/quant.py), emitted as (vals [B, k], idx
// [B, k]) in ascending index order, (0, 0)-padded.
//
// Design. K2's two deterministic passes (fused_topk.cu); only pass 1's tile
// product differs. A block computes a [128, 128] tile: x's int8 rows and
// the W columns (stored transposed, [width, nd], so a column's contraction
// run is contiguous) are staged in shared memory 32 contraction bytes at a
// time as 4-byte words, and each thread sums an 8 x 8 register tile of
// int32 products with __dp4a over one contraction block (exact: |p| <=
// block * 127^2 < 2^31), then folds it into its f32 tile as
// __fadd_rn(acc, __fmul_rn(__fmul_rn(float(p), xs), ws)), blocks in
// ascending order. The explicit _rn intrinsics keep nvcc from contracting
// the multiply and add into an FMA, so each step rounds as the plain
// version's elementwise torch ops do and the two agree bit for bit. The
// bias is added in f32, the sum rounded to the compute dtype, and each
// 64-row half of the tile is ranked and written as K2's tile candidates;
// the merge is K2's (fused_topk_select.cuh).
//
// Bound. At the training shape (x [4096, 4608], W [4608, 32768], block
// 256) the product is 2 * 4096 * 4608 * 32768 = 1.24 T int8 operations,
// 0.625 ms at the card's 1979 TOPS int8 peak; the bytes (int8 operands,
// scales, the output) about 172 MB, 0.05 ms. This design runs the product
// on the CUDA cores (__dp4a), not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_topk_select.cuh"

namespace {

using fsel::kCW;

constexpr int kThreads = 256;
constexpr int kBM = 128;          // tile rows
constexpr int kWords = 8;         // contraction words (4 bytes each) staged a step: 32 bytes
constexpr int kHalfRows = 64;     // rows ranked a round (the keys' shared memory)

// dynamic shared memory: the staged operands, then the keys of 64 rows
constexpr size_t kOperandBytes = size_t(2) * kWords * kBM * sizeof(int);
constexpr size_t kSmem = kOperandBytes + size_t(kHalfRows) * kCW * sizeof(long long);

__device__ __forceinline__ int tile_row(int ty, int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
topk_tiles_q_kernel(const int8_t* __restrict__ xq,   // [B, nd]
                    const float* __restrict__ xs,    // [B, nb]
                    const int8_t* __restrict__ wqT,  // [width, nd]
                    const float* __restrict__ ws,    // [nb, width]
                    const float* __restrict__ b,     // [width]
                    long long* __restrict__ cand,    // [B, n_tiles, k]
                    int B, int nd, int width, int k, int qb) {
  extern __shared__ __align__(16) unsigned char smem[];
  int (*As)[kBM] = reinterpret_cast<int (*)[kBM]>(smem);                     // [kWords][kBM]
  int (*Bs)[kCW] = reinterpret_cast<int (*)[kCW]>(smem + kWords * kBM * sizeof(int));
  long long* keys = reinterpret_cast<long long*>(smem + kOperandBytes);     // [64][kCW]

  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int row0 = blockIdx.y * kBM, c0 = tile * kCW;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nb = nd / qb;

  // loaders: row / column (tid >> 1), 16 contraction bytes at (tid & 1) * 16
  const int lm = tid >> 1, lh = tid & 1;
  const bool x_ok = row0 + lm < B, w_ok = c0 + lm < width;
  const int8_t* xp = xq + size_t(row0 + lm) * nd + lh * 16;
  const int8_t* wp = wqT + size_t(c0 + lm) * nd + lh * 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int q = 0; q < nb; ++q) {
    int p[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) p[i][j] = 0;
    for (int k0 = q * qb; k0 < (q + 1) * qb; k0 += kWords * 4) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4 xv = x_ok ? __ldg(reinterpret_cast<const uint4*>(xp + k0)) : zero;
      const uint4 wv = w_ok ? __ldg(reinterpret_cast<const uint4*>(wp + k0)) : zero;
      As[lh * 4 + 0][lm] = int(xv.x);
      As[lh * 4 + 1][lm] = int(xv.y);
      As[lh * 4 + 2][lm] = int(xv.z);
      As[lh * 4 + 3][lm] = int(xv.w);
      Bs[lh * 4 + 0][lm] = int(wv.x);
      Bs[lh * 4 + 1][lm] = int(wv.y);
      Bs[lh * 4 + 2][lm] = int(wv.z);
      Bs[lh * 4 + 3][lm] = int(wv.w);
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int4 a0 = *reinterpret_cast<const int4*>(&As[w][ty * 4]);
        const int4 a1 = *reinterpret_cast<const int4*>(&As[w][64 + ty * 4]);
        const int4 b0 = *reinterpret_cast<const int4*>(&Bs[w][tx * 4]);
        const int4 b1 = *reinterpret_cast<const int4*>(&Bs[w][64 + tx * 4]);
        const int a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const int bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i][j] = __dp4a(a[i], bb[j], p[i][j]);
      }
      __syncthreads();
    }
    // fold block q into the f32 tile, in the plain version's rounding order
    float sx[8], sw[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + tile_row(ty, i);
      sx[i] = r < B ? xs[size_t(r) * nb + q] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      sw[j] = c < width ? ws[size_t(q) * width + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__fmul_rn(__int2float_rn(p[i][j]), sx[i]), sw[j]));
  }

  // each 64-row half: keys into shared memory, then warp w ranks rows w, w + 8, ...
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int i = half * 4 + ii;
      const int lr = ty * 4 + ii;                       // row within the half
      const int r = row0 + half * 64 + lr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = (j >> 2) * 64 + tx * 4 + (j & 3);
        const int c = c0 + cl;
        long long comp = 0;
        if (r < B && c < width) {
          const float hc = fsel::to_f(fsel::from_f<T>(__fadd_rn(acc[i][j], b[c])));
          comp = fsel::composite(fsel::select_key(hc), c);
        }
        keys[lr * kCW + cl] = comp;
      }
    }
    __syncthreads();
    for (int lr = warp; lr < kHalfRows; lr += kThreads / 32) {
      const int r = row0 + half * 64 + lr;
      if (r < B)
        fsel::rank_row_candidates(keys + lr * kCW, cand + (size_t(r) * n_tiles + tile) * k, k,
                                  lane);
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* xq, const void* xs, const void* wqT, const void* ws, const void* b,
           void* cand, void* cand2, void* vals, void* idx, int B, int nd, int width, int k,
           int qb, int group, cudaStream_t stream) {
  const int n_tiles = (width + kCW - 1) / kCW;
  auto k1 = topk_tiles_q_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  dim3 grid1(n_tiles, (B + kBM - 1) / kBM);
  k1<<<grid1, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wqT), static_cast<const float*>(ws),
      static_cast<const float*>(b), static_cast<long long*>(cand), B, nd, width, k, qb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return fsel::launch_merge<T>(cand, cand2, vals, idx, B, n_tiles, k, group, stream);
}

}  // namespace

extern "C" int fused_topk_q_launch(const void* xq, const void* xs, const void* wqT,
                                   const void* ws, const void* b, void* cand, void* cand2,
                                   void* vals, void* idx, int B, int nd, int width, int k,
                                   int qb, int group, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(xq, xs, wqT, ws, b, cand, cand2, vals, idx, B, nd, width, k,
                                 qb, group, st);
  return launch<float>(xq, xs, wqT, ws, b, cand, cand2, vals, idx, B, nd, width, k, qb, group,
                       st);
}

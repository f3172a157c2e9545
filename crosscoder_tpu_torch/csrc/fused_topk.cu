// Fused encoder -> TopK for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/fused_encoder_topk.py
// `_fused_topk_kernel` (reached through `fused_topk_encode`): per row of x,
// the exact top-k of relu(cast(x . W + b)) without writing the [B, width]
// pre-activation matrix, emitted as (vals [B, k], idx [B, k]) in ascending
// index order, (0, 0)-padded.
//
// Design. The TPU kernel carries a running top-k in VMEM across a
// sequential grid axis over dictionary tiles. Hopper blocks run in no
// order, so the selection is split in two deterministic passes with no
// atomics:
//   pass 1 writes each [row, 128-column tile]'s best k candidates, in rank
//     order, to a [B, n_tiles, k] scratch;
//   pass 2, one block per row, merges the n_tiles * k candidates, with a
//     first level over groups of tiles at wide dictionaries (1024 tiles of
//     32 at 2^17).
// The keys, the f32 tile ranking and the merge are fused_topk_select.cuh's,
// shared with the int8 kernel (fused_topk_q.cu).
//
// Pass 1, bf16: encoder_tile_sm90.cuh's tensor-core tile (persistent grid,
// TMA ring, two consumer warpgroups of wgmma, fp32 sums). Its epilogue
// (fsel::TileTopk, shared with K3) adds the bias in f32, rounds to bf16 as
// `pre_acts` does and stages the tile's keys in shared memory as 32-bit
// composites (the bf16 key's 16 bits, then 127 - the column in the tile: a
// bf16 pattern's low 16 f32 bits are 0); a warp then sorts each row of its
// 16 (a bitonic sort of 128) and writes the row's candidates in the 64-bit
// format of fused_topk_select.cuh.
// Pass 1, f32: the CUDA cores (a tensor-core f32 product would be TF32): a
// block computes an [8, 128] tile with fp32 FMAs (16 contraction splits x
// 16 column groups of 8, partial sums added in a fixed order) and ranks it
// with fsel::rank_row_candidates.
//
// Bound. At the training shape (x [4096, 4608], W [4608, 32768] bf16) the
// product is 1.24 TFLOP: 1.2507 ms at the bf16 tensor-core peak, above the
// 0.10 ms its 340 MB take; the tile puts it on the tensor cores and reads W
// about once. At the serve shape (x [8, 4608], W [4608, 16384]) the
// function reads W once: 151 MB, 0.0451 ms at 3.35 TB/s, against 1.2 us of
// product; there the 128 column tiles stream W once through the TMA ring
// (rows past 8 are TMA's zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile_sm90.cuh"
#include "fused_topk_select.cuh"

namespace {

using fsel::composite;
using fsel::kCW;

// --- bf16 pass 1 on the tensor-core tile ----------------------------------

constexpr int kStages = 4;

constexpr size_t kTcSmem =
    etile::ring_bytes(kStages) + size_t(etile::kBM) * fsel::kKeyPitch * 4 + etile::kAlign;

__global__ void __launch_bounds__(etile::kThreads, 1)
topk_tiles_tc(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
              const float* __restrict__ b, long long* __restrict__ cand, int B, int nd, int width,
              int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = etile::align_smem(smem_raw);
  fsel::TileTopk<__nv_bfloat16> epi{
      b, cand, reinterpret_cast<uint32_t*>(ring + etile::ring_bytes(kStages)), B, width, k,
      (width + etile::kBN - 1) / etile::kBN};
  etile::run_tiles<kStages>(&xm, &wm, ring, B, nd, width, epi);
}

int launch_tc(const void* x, const void* W, const void* b, void* cand, void* cand2, void* vals,
              void* idx, int B, int nd, int width, int k, int group, cudaStream_t stream) {
  const int e = etile::launch(topk_tiles_tc, kTcSmem, x, W, B, nd, width, stream,
                              static_cast<const float*>(b), static_cast<long long*>(cand), B, nd,
                              width, k);
  if (e != 0) return e;
  return fsel::launch_merge<__nv_bfloat16>(cand, cand2, vals, idx, B, (width + kCW - 1) / kCW, k,
                                           group, stream);
}

// --- f32 pass 1 on the CUDA cores ------------------------------------------

constexpr int kThreads = 256;
constexpr int kRowsPB = 8;     // rows per block
constexpr int kSplit = 16;     // contraction splits
constexpr int kVec = 8;        // columns per thread

size_t tiles_smem(int nd) {
  size_t x_bytes = size_t(kRowsPB) * nd * sizeof(float);
  size_t red_bytes = size_t(kSplit) * kRowsPB * kCW * sizeof(float);
  size_t region = x_bytes > red_bytes ? x_bytes : red_bytes;
  region = (region + 15) / 16 * 16;
  return region + size_t(kRowsPB) * kCW * sizeof(long long);
}

__global__ void __launch_bounds__(kThreads)
topk_tiles_kernel(const float* __restrict__ x,  // [B, nd]
                  const float* __restrict__ W,  // [nd, width]
                  const float* __restrict__ b,  // [width]
                  long long* __restrict__ cand, // [B, n_tiles, k]
                  int B, int nd, int width, int k, size_t region) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);       // [kRowsPB][nd]
  float* red = reinterpret_cast<float*>(smem);      // [kSplit][kRowsPB][kCW], after the matmul
  long long* keys = reinterpret_cast<long long*>(smem + region);  // [kRowsPB][kCW]

  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = blockIdx.y * kRowsPB;
  const int c0 = tile * kCW;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRowsPB * nd; i += kThreads) {
    const int r = i / nd;
    xs[i] = row0 + r < B ? x[size_t(row0) * nd + i] : 0.f;
  }
  __syncthreads();

  const int cg = tid % (kCW / kVec);
  const int ks = tid / (kCW / kVec);
  const int col = c0 + cg * kVec;
  float acc[kRowsPB][kVec];
#pragma unroll
  for (int r = 0; r < kRowsPB; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[r][j] = 0.f;
  if (col < width) {
    const float* wp = W + col;
#pragma unroll 4
    for (int kk = ks; kk < nd; kk += kSplit) {
      // 8 consecutive columns from a 32-byte boundary
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp + size_t(kk) * width));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + size_t(kk) * width) + 1);
      const float w[kVec] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < kRowsPB; ++r) {
        const float xv = xs[r * nd + kk];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
      }
    }
  }
  __syncthreads();  // xs is dead: red reuses its space
#pragma unroll
  for (int r = 0; r < kRowsPB; ++r)
#pragma unroll
    for (int j = 0; j < kVec; ++j) red[(ks * kRowsPB + r) * kCW + cg * kVec + j] = acc[r][j];
  __syncthreads();

  for (int o = tid; o < kRowsPB * kCW; o += kThreads) {
    const int r = o / kCW, c = o % kCW, gcol = c0 + c;
    long long comp = 0;
    if (gcol < width) {
      float h = red[r * kCW + c];
      for (int s = 1; s < kSplit; ++s) h += red[(s * kRowsPB + r) * kCW + c];
      comp = composite(fsel::select_key(h + b[gcol]), gcol);
    }
    keys[o] = comp;
  }
  __syncthreads();

  // warp w ranks row w of the tile
  const int w = tid >> 5, lane = tid & 31;
  const int row = row0 + w;
  if (row >= B) return;
  fsel::rank_row_candidates(keys + w * kCW, cand + (size_t(row) * n_tiles + tile) * k, k, lane);
}

int launch_f32(const void* x, const void* W, const void* b, void* cand, void* cand2, void* vals,
               void* idx, int B, int nd, int width, int k, int group, cudaStream_t stream) {
  const int n_tiles = (width + kCW - 1) / kCW;
  const size_t smem1 = tiles_smem(nd);
  size_t region = smem1 - size_t(kRowsPB) * kCW * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(topk_tiles_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem1));
  if (err != cudaSuccess) return int(err);
  dim3 grid1(n_tiles, (B + kRowsPB - 1) / kRowsPB);
  topk_tiles_kernel<<<grid1, kThreads, smem1, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(W), static_cast<const float*>(b),
      static_cast<long long*>(cand), B, nd, width, k, region);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return fsel::launch_merge<float>(cand, cand2, vals, idx, B, n_tiles, k, group, stream);
}

}  // namespace

extern "C" int fused_topk_launch(const void* x, const void* W, const void* b, void* cand,
                                 void* cand2, void* vals, void* idx, int B, int nd, int width,
                                 int k, int group, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_tc(x, W, b, cand, cand2, vals, idx, B, nd, width, k, group, st);
  return launch_f32(x, W, b, cand, cand2, vals, idx, B, nd, width, k, group, st);
}

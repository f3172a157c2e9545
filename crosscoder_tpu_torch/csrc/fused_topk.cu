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
//   pass 1, grid (dict_tile, row_block): a block computes the [8, 128]
//     pre-activation tile with fp32 accumulation (16 contraction splits x
//     16 column groups of 8, partial sums added in a fixed order), adds the
//     bias and rounds to the compute dtype exactly as `pre_acts` does, maps
//     each value to its selection key and writes the tile's best k
//     candidates of each row, in rank order, to a [B, n_tiles, k] scratch.
//   pass 2, one block per row: merges the n_tiles * k candidates, with a
//     first level over groups of tiles at wide dictionaries (1024 tiles of
//     32 at 2^17).
// The keys, the tile ranking and the merge are fused_topk_select.cuh's,
// shared with the int8 kernel (fused_topk_q.cu).
//
// Bound. At the serve shape (x [8, 4608] bf16, W_enc [4608, 16384] bf16)
// the function reads W_enc once: 151 MB, 45 us at 3.35 TB/s, against 1.2
// GFLOP (1.2 us at the bf16 tensor-core peak), so it is bound by bytes.
// Pass 1 streams W with 16-byte loads per thread and keeps the x rows in
// shared memory; the multiply runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_topk_select.cuh"

namespace {

using fsel::composite;
using fsel::from_f;
using fsel::kCW;
using fsel::to_f;

constexpr int kThreads = 256;
constexpr int kRowsPB = 8;     // rows per block in pass 1
constexpr int kSplit = 16;     // contraction splits in pass 1
constexpr int kVec = 8;        // columns per thread in pass 1

// 8 consecutive elements starting at a 16-byte (bf16) / 32-byte (f32) boundary
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

template <typename T>
size_t tiles_smem(int nd) {
  size_t x_bytes = size_t(kRowsPB) * nd * sizeof(T);
  size_t red_bytes = size_t(kSplit) * kRowsPB * kCW * sizeof(float);
  size_t region = x_bytes > red_bytes ? x_bytes : red_bytes;
  region = (region + 15) / 16 * 16;
  return region + size_t(kRowsPB) * kCW * sizeof(long long);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_tiles_kernel(const T* __restrict__ x,      // [B, nd]
                  const T* __restrict__ W,      // [nd, width]
                  const float* __restrict__ b,  // [width]
                  long long* __restrict__ cand, // [B, n_tiles, k]
                  int B, int nd, int width, int k, size_t region) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);               // [kRowsPB][nd]
  float* red = reinterpret_cast<float*>(smem);      // [kSplit][kRowsPB][kCW], after the matmul
  long long* keys = reinterpret_cast<long long*>(smem + region);  // [kRowsPB][kCW]

  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int row0 = blockIdx.y * kRowsPB;
  const int c0 = tile * kCW;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRowsPB * nd; i += kThreads) {
    const int r = i / nd;
    xs[i] = row0 + r < B ? x[size_t(row0) * nd + i] : from_f<T>(0.f);
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
    const T* wp = W + col;
#pragma unroll 4
    for (int kk = ks; kk < nd; kk += kSplit) {
      float w[kVec];
      load8(wp + size_t(kk) * width, w);
#pragma unroll
      for (int r = 0; r < kRowsPB; ++r) {
        const float xv = to_f(xs[r * nd + kk]);
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
      comp = composite(fsel::select_key(to_f(from_f<T>(h + b[gcol]))), gcol);
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

template <typename T>
int launch(const void* x, const void* W, const void* b, void* cand, void* cand2, void* vals,
           void* idx, int B, int nd, int width, int k, int group, cudaStream_t stream) {
  const int n_tiles = (width + kCW - 1) / kCW;
  const size_t smem1 = tiles_smem<T>(nd);
  size_t region = smem1 - size_t(kRowsPB) * kCW * sizeof(long long);
  auto k1 = topk_tiles_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem1));
  if (err != cudaSuccess) return int(err);
  dim3 grid1(n_tiles, (B + kRowsPB - 1) / kRowsPB);
  k1<<<grid1, kThreads, smem1, stream>>>(static_cast<const T*>(x), static_cast<const T*>(W),
                                         static_cast<const float*>(b),
                                         static_cast<long long*>(cand), B, nd, width, k, region);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return fsel::launch_merge<T>(cand, cand2, vals, idx, B, n_tiles, k, group, stream);
}

}  // namespace

extern "C" int fused_topk_launch(const void* x, const void* W, const void* b, void* cand,
                                 void* cand2, void* vals, void* idx, int B, int nd, int width,
                                 int k, int group, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, W, b, cand, cand2, vals, idx, B, nd, width, k, group, st);
  return launch<float>(x, W, b, cand, cand2, vals, idx, B, nd, width, k, group, st);
}

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
// Design. K2's two deterministic passes (fused_topk.cu) on the shared
// tensor-core tile (encoder_tile_sm90.cuh, run_tiles_q): a persistent grid
// over [128, 128] output tiles, a TMA ring whose stages hold an xq box
// [128 rows x 128 contraction bytes], a wqT box [128 columns x 128 bytes]
// (W stored transposed, [width, nd], so both operands are K-major, as the
// 8-bit wgmma needs) and the stage's scale rows of xsT [nb, B] and ws
// [nb, width]; two consumer warpgroups of wgmma m64n128k32 .s32.s8.s8, each
// block's int32 sum exact (|p| <= block * 127^2 < 2^31) in any order, then
// folded into an f32 accumulator in the main loop at each block's end as
// __fadd_rn(acc, __fmul_rn(__fmul_rn(float(p), xs), ws)), blocks in
// ascending order. The explicit _rn intrinsics keep nvcc from contracting
// the multiply and add into an FMA, so each step rounds as the plain
// version's elementwise torch ops do and the two agree bit for bit, in
// bf16 and f32 alike. The epilogue is K2's (fsel::TileTopk): the bias in
// f32, the sum rounded to the compute dtype, each row-tile's keys staged
// and bitonic-sorted by a warp into the [B, n_tiles, k] candidates; the
// merge is K2's (fused_topk_select.cuh).
//
// Bound. At the training shape (x [4096, 4608], W [4608, 32768], block
// 256) the product is 2 * 4096 * 4608 * 32768 = 1.24 T int8 operations,
// 0.625 ms at the card's 1979 TOPS int8 peak; the bytes (int8 operands,
// scales, the output) about 172 MB, 0.05 ms. The tile reads wqT about once
// and runs the product on the tensor cores; the fold adds a conversion and
// three rounded CUDA-core operations an accumulator a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encoder_tile_sm90.cuh"
#include "fused_topk_select.cuh"

namespace {

constexpr int kStages = 4;

constexpr size_t kSmem = etile::ring_bytes(kStages, etile::kQStageBytes) +
                         size_t(etile::kBM) * fsel::kKeyPitch * 4 + etile::kAlign;

template <typename T, bool kAligned>
__global__ void __launch_bounds__(etile::kThreads, 1)
topk_tiles_q_tc(const __grid_constant__ CUtensorMap xm, const __grid_constant__ CUtensorMap wm,
                const __grid_constant__ CUtensorMap xsm, const __grid_constant__ CUtensorMap wsm,
                const float* __restrict__ b, long long* __restrict__ cand, int B, int nd,
                int width, int k, int qb, int nbs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = etile::align_smem(smem_raw);
  fsel::TileTopk<T> epi{
      b, cand, reinterpret_cast<uint32_t*>(ring + etile::ring_bytes(kStages, etile::kQStageBytes)),
      B, width, k, (width + etile::kBN - 1) / etile::kBN};
  etile::run_tiles_q<kStages, kAligned>(&xm, &wm, &xsm, &wsm, ring, B, nd, width, qb, nbs, epi);
}

// xq [B, nd] and wqT [width, nd] int8; xsT [nb, Bp] f32 (Bp >= B, a
// multiple of 4: 16-byte rows); ws [nb, width] f32 (width % 8 == 0, the
// wrapper's gate).
template <typename T>
int launch(const void* xq, const void* xsT, const void* wqT, const void* ws, const void* b,
           void* cand, void* cand2, void* vals, void* idx, int B, int Bp, int nd, int width,
           int k, int qb, int group, cudaStream_t stream) {
  const int nb = nd / qb, nbs = etile::q_scale_rows(qb);
  CUtensorMap xm, wm, xsm, wsm;
  int e = etile::encode_map_of(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_128B,
                               xq, uint64_t(nd), uint64_t(B), etile::kQBK, etile::kBM);
  if (e == 0)
    e = etile::encode_map_of(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_128B,
                             wqT, uint64_t(nd), uint64_t(width), etile::kQBK, etile::kBN);
  if (e == 0)
    e = etile::encode_map_of(&xsm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, CU_TENSOR_MAP_SWIZZLE_NONE,
                             xsT, uint64_t(Bp), uint64_t(nb), etile::kBM, uint32_t(nbs));
  if (e == 0)
    e = etile::encode_map_of(&wsm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, CU_TENSOR_MAP_SWIZZLE_NONE,
                             ws, uint64_t(width), uint64_t(nb), etile::kBN, uint32_t(nbs));
  if (e != 0) return e;
  // blocks of whole stages take the stage loop
  auto kern = qb % etile::kQBK == 0 ? topk_tiles_q_tc<T, true> : topk_tiles_q_tc<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const int total = etile::n_tiles(B, width), sms = etile::sm_count();
  kern<<<total < sms ? total : sms, etile::kThreads, kSmem, stream>>>(
      xm, wm, xsm, wsm, static_cast<const float*>(b), static_cast<long long*>(cand), B, nd, width,
      k, qb, nbs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return fsel::launch_merge<T>(cand, cand2, vals, idx, B, (width + fsel::kCW - 1) / fsel::kCW, k,
                               group, stream);
}

}  // namespace

extern "C" int fused_topk_q_launch(const void* xq, const void* xsT, const void* wqT,
                                   const void* ws, const void* b, void* cand, void* cand2,
                                   void* vals, void* idx, int B, int Bp, int nd, int width, int k,
                                   int qb, int group, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(xq, xsT, wqT, ws, b, cand, cand2, vals, idx, B, Bp, nd, width,
                                 k, qb, group, st);
  return launch<float>(xq, xsT, wqT, ws, b, cand, cand2, vals, idx, B, Bp, nd, width, k, qb,
                       group, st);
}

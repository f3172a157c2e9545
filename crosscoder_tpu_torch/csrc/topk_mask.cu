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
// patterns equal to v*. Rows with fewer than k positives keep all of them
// and zeros elsewhere.
//
// Design: topk_slice.cuh with one block a row (a cluster of one), the
// kernel K7's cluster route runs for bf16. The row comes into shared
// memory with one bulk copy (2 bytes a column: 64 KB at width 32768, so
// three blocks fit an SM, one block's load overlapping another's select);
// v* is found by the radix select in two passes over shared memory (bits
// 14-8, then 7-0 of the 15-bit keys) where the TPU kernel, and this file
// before, bisected in up to 15 halvings; the emit writes the row with
// 16-byte stores, walking it in column order only when some ties at v* are
// dropped.
//
// Bound. The function reads h once and writes out once: at [4096, 32768]
// bf16 that is 2 x 268 MB, 0.16 ms at 3.35 TB/s; it does no tensor-core
// work. Device memory sees exactly those two passes.

#include <cuda_runtime.h>

#include "topk_slice.cuh"

extern "C" int topk_mask_launch(const void* h, void* out, int R, int W, int k, int vec,
                                void* stream) {
  return tslice::launch<true>(h, out, R, W, (W + 7) / 8 * 8, 1, k, vec,
                              static_cast<cudaStream_t>(stream));
}

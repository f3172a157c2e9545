// Sorted-pair scatter-accumulate for Hopper (sm_90a):
// out[dst[p], :] += cf[p] * rows[src[p], :] over pairs sorted by dst.
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/sparse_grad.py
// `_scatter_rows_kernel` (reached through `scatter_add_rows`). As there,
// the pair list is sorted by destination (stably, so duplicate
// destinations keep their batch-major order) and cut into per-row-block
// ranges by a searchsorted, both in PyTorch before the launch; pairs
// whose destination is out of range carry the sentinel dst = n_out and
// lie past every range, so they are dropped. Sums are f32.
//
// Design. A block owns a [kRB, kMC] tile of out (kRB destination rows,
// kMC = 512 columns, 128 threads, each thread 4 columns at stride 128 so
// a warp's loads and stores are contiguous). It walks its own range of the
// sorted pairs once, in order, accumulating cf * rows[src] into registers,
// and stores each destination row of the tile when the walk moves past it,
// zeros included: every element of out is written exactly once, by one
// thread, with no atomics. Each thread adds in the sorted pair order with
// __fadd_rn(acc, __fmul_rn(c, r)), so the compiler cannot contract the
// product into an FMA and the result is bitwise the plain version's
// (out[d] = out[d] + c * r, rank by rank, in the same order). The next
// pair's row values are loaded before the current pair is added.
//
// Bound. Each call writes out once ([32768, 4608] f32 = 604 MB at the
// training shape) and needs the rows ([4096, 4608] f32 = 75 MB) and the
// pair list once: about 0.2 ms at 3.35 TB/s, bound by bytes. This kernel
// re-reads a source row for every pair that names it (k times at TopK),
// mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kMC = kThreads * kPerThread;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void load_pair(const int* __restrict__ dst, const int* __restrict__ src,
                                          const float* __restrict__ cf,
                                          const T* __restrict__ rows, int m, int col0, int p,
                                          int& d, float& c, float* v) {
  d = __ldg(dst + p);
  c = __ldg(cf + p);
  const T* rr = rows + size_t(__ldg(src + p)) * m;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int col = col0 + i * kThreads;
    v[i] = col < m ? to_f(rr[col]) : 0.f;
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ out, int m, int col0, int r,
                                          float* acc) {
  float* orow = out + size_t(r) * m;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int col = col0 + i * kThreads;
    if (col < m) orow[col] = acc[i];
    acc[i] = 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int* __restrict__ dst, const int* __restrict__ src,
                    const float* __restrict__ cf, const int* __restrict__ starts,
                    const T* __restrict__ rows, float* __restrict__ out, int n_out, int m,
                    int rb) {
  const int blk = blockIdx.x;
  const int r0 = blk * rb, r1 = min(r0 + rb, n_out);
  const int col0 = blockIdx.y * kMC + threadIdx.x;
  const int s = starts[blk], e = starts[blk + 1];
  float acc[kPerThread] = {0.f, 0.f, 0.f, 0.f};
  int cur = r0;
  int dn = 0;
  float cn = 0.f, vn[kPerThread];
  if (s < e) load_pair(dst, src, cf, rows, m, col0, s, dn, cn, vn);
  for (int p = s; p < e; ++p) {
    const int d = dn;
    const float c = cn;
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) v[i] = vn[i];
    if (p + 1 < e) load_pair(dst, src, cf, rows, m, col0, p + 1, dn, cn, vn);
    while (cur < d) store_row(out, m, col0, cur++, acc);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(c, v[i]));
  }
  while (cur < r1) store_row(out, m, col0, cur++, acc);
}

template <typename T>
int launch(const void* dst, const void* src, const void* cf, const void* starts,
           const void* rows, void* out, int n_out, int m, int rb, cudaStream_t stream) {
  dim3 grid((n_out + rb - 1) / rb, (m + kMC - 1) / kMC);
  scatter_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(dst), static_cast<const int*>(src),
      static_cast<const float*>(cf), static_cast<const int*>(starts),
      static_cast<const T*>(rows), static_cast<float*>(out), n_out, m, rb);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int scatter_rows_launch(const void* dst, const void* src, const void* cf,
                                   const void* starts, const void* rows, void* out, int n_out,
                                   int m, int rb, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(dst, src, cf, starts, rows, out, n_out, m, rb, st);
  return launch<float>(dst, src, cf, starts, rows, out, n_out, m, rb, st);
}

// Global-threshold BatchTopK for Hopper (sm_90a): the exact (k·B)-th
// largest ReLU'd entry of a whole batch, and the mask that keeps every
// entry at or above it.
//
// Replaces the Pallas TPU kernels crosscoder_tpu/ops/topk_pallas.py
// `_batchtopk_bisect_kernel` (select) and `_batchtopk_emit_kernel` (emit),
// reached through `batchtopk` and, for the emit alone, `batchtopk_fixed`.
//
// Patterns. Every entry maps to a non-negative integer pattern whose order
// is the order of its ReLU'd value: bf16 entries use their 16-bit pattern
// (15 bits once the sign is gone), f32 entries their 32-bit one (31 bits).
// A sign-set pattern (negative values, -0.0, -inf) maps to 0; a NaN maps
// to the largest pattern below the top of its range (bf16 0x7FFE, f32
// 0x7FFFFFFE): a positive NaN's payload is clamped there, a negative NaN
// (sign-set, above -inf) is taken there as well. This is the rule of the
// TopK mask kernel (topk_mask.cu) on bit patterns, so a NaN ranks above
// +inf, takes a slot of the budget and is emitted as the NaN of its
// clamped pattern, whatever a backend's max(x, 0) would do with it.
//
// Select. kth = the largest pattern p >= 0 with count(pattern >= p) >= kk,
// kk = min(k·rows, numel): the value the TPU's bisection converges to;
// p = 0 keeps every positive entry. Counts are 64-bit.
//   bf16: one pass. Each block (one per SM, 1024 threads) builds a
//   32768-bin count histogram of the positive patterns in shared memory
//   (128 KB) with integer atomics, flushes its non-zero bins into a global
//   64-bit histogram, and the last block to finish (a fence and an atomic
//   ticket) walks the histogram's suffix sums to the answer. Integer adds
//   make the result independent of the order blocks run in.
//   f32: the 31-bit patterns do not fit a shared histogram, so select runs
//   the multi-threshold bisection of the JAX package (T = 15 thresholds a
//   pass, 8 passes): each pass is one launch whose blocks count
//   `pattern >= mid_j` for all 15 candidates and add their counts into
//   64-bit totals; the last block narrows [lo, hi) for the next pass.
// Neither path syncs with the host: the threshold stays a device int32.
//
// Emit. out = (pattern >= kth && pattern > 0) ? value of the pattern : 0;
// `batchtopk_fixed` launches it alone with a threshold pattern computed on
// the host. It reads h once and writes out once: 537 MB at [4096, 32768]
// bf16, 0.16 ms at 3.35 TB/s, by bytes, with one compare and select an
// entry. So the emit is a pure stream, and the design keeps enough bytes
// in flight to reach the memory's rate: the grid has one thread for every
// 16-byte vector (a block's warps on consecutive 512-byte runs; no
// grid-stride loop capped at a few blocks an SM), each thread loads its
// vector, masks it and stores it, and out goes out with streaming stores
// (st.global.cs) so it does not evict h, which the AuxK ranking reads
// again, from L2. h keeps the default policy. On an H100 at 700 W one
// load a thread ran 0.4-1.1% behind F.threshold, 2 independent loads a
// thread 0.9-1.2%, 4 or 8 2.1-3.4% (scripts/torch_kernel_variants.py
// emit), so the kernel keeps one. An unaligned h or out
// (`vec` = 0) takes one entry a thread; the n % 8 (bf16) or n % 4 (f32)
// entries past the last vector go to the first threads of the grid.
//
// Bound. Select reads the batch once, emit reads it once and writes it
// once: 805 MB at [4096, 32768] bf16, 0.24 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 1024;
constexpr int kBins = 1 << 15;
constexpr int kT = 15;
constexpr int kCountThreads = 256;
constexpr int kEmitThreads = 256;

__device__ __forceinline__ unsigned pattern16(unsigned b) {
  if (b & 0x8000u) return b > 0xFF80u ? 0x7FFEu : 0u;
  return b < 0x7FFEu ? b : 0x7FFEu;
}

__device__ __forceinline__ unsigned pattern32(unsigned b) {
  if (b & 0x80000000u) return b > 0xFF800000u ? 0x7FFFFFFEu : 0u;
  return b < 0x7FFFFFFEu ? b : 0x7FFFFFFEu;
}

// ---------------------------------------------------------------- bf16 select

__device__ __forceinline__ void bin_add(unsigned* bins, unsigned b) {
  const unsigned p = pattern16(b);
  if (p) atomicAdd(&bins[p], 1u);
}

__global__ void __launch_bounds__(kHistThreads)
bt_hist_bf16(const uint16_t* __restrict__ h, long long n, long long kk, int vec,
             unsigned long long* __restrict__ hist, unsigned* __restrict__ ticket,
             int* __restrict__ kth) {
  extern __shared__ unsigned bins[];
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n8 = vec ? n / 8 : 0;
  for (long long i = start; i < n8; i += stride) {
    union { uint4 u; uint16_t s[8]; } d;
    d.u = __ldg(reinterpret_cast<const uint4*>(h) + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) bin_add(bins, d.s[j]);
  }
  for (long long i = n8 * 8 + start; i < n; i += stride) bin_add(bins, h[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < kBins; i += blockDim.x)
    if (bins[i]) atomicAdd(&hist[i], (unsigned long long)bins[i]);
  __threadfence();
  __syncthreads();

  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block: thread t owns bins [t*32, t*32 + 32). A suffix scan of
  // the threads' sums gives each the count above its range; each thread
  // then walks its bins top-down to the first (largest) p whose suffix
  // count reaches kk, and the block keeps the largest such p.
  constexpr int per = kBins / kHistThreads;
  unsigned long long* sums = reinterpret_cast<unsigned long long*>(bins);
  __shared__ int best;
  const int t = threadIdx.x;
  unsigned long long mine = 0;
  for (int q = 0; q < per; ++q) mine += __ldcg(&hist[t * per + q]);
  if (t == 0) best = 0;
  sums[t] = mine;
  __syncthreads();
  for (int o = 1; o < kHistThreads; o <<= 1) {        // inclusive suffix scan
    const unsigned long long add = t + o < kHistThreads ? sums[t + o] : 0ull;
    __syncthreads();
    sums[t] += add;
    __syncthreads();
  }
  unsigned long long run = t + 1 < kHistThreads ? sums[t + 1] : 0ull;
  for (int q = per - 1; q >= 0; --q) {
    const int p = t * per + q;
    if (p == 0) break;
    run += __ldcg(&hist[p]);
    if (run >= (unsigned long long)kk) {
      atomicMax(&best, p);
      break;
    }
  }
  __syncthreads();
  if (t == 0) *kth = best;
}

// ----------------------------------------------------------------- f32 select

struct BisectState {            // 64-bit words, zeroed by the wrapper but lo/hi
  long long lo, hi;
  unsigned long long counts[kT];
  unsigned long long ticket;
};

__device__ __forceinline__ long long mid_of(long long lo, long long hi, int j) {
  const long long r1 = hi - lo - 1;
  const long long q = r1 / kT;
  const long long rem = r1 - q * kT;
  return lo + 1 + q * j + (rem * j) / kT;
}

__global__ void __launch_bounds__(kCountThreads)
bt_bisect_f32(const float* __restrict__ h, long long n, long long kk, int vec,
              BisectState* __restrict__ st, int* __restrict__ kth, int final_pass) {
  const long long lo = st->lo, hi = st->hi;
  unsigned mids[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) mids[j] = unsigned(mid_of(lo, hi, j));
  unsigned cnt[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) cnt[j] = 0;

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = start; i < n4; i += stride) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(h) + i);
    const unsigned b[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned p = pattern32(b[e]);
#pragma unroll
      for (int j = 0; j < kT; ++j) cnt[j] += p >= mids[j];
    }
  }
  for (long long i = n4 * 4 + start; i < n; i += stride) {
    const unsigned p = pattern32(__float_as_uint(h[i]));
#pragma unroll
    for (int j = 0; j < kT; ++j) cnt[j] += p >= mids[j];
  }

  __shared__ unsigned long long part[kT];
  if (threadIdx.x < kT) part[threadIdx.x] = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    unsigned long long c = cnt[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(&part[j], c);
  }
  __syncthreads();
  if (threadIdx.x < kT) atomicAdd(&st->counts[threadIdx.x], part[threadIdx.x]);
  __threadfence();
  __syncthreads();

  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicAdd(&st->ticket, 1ull) == (unsigned long long)(gridDim.x - 1);
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  // counts fall as the mids rise, so (count >= kk) holds for a prefix of
  // the candidates: the last of them is the new lo, the next the new hi
  int num_ge = 0;
  for (int j = 0; j < kT; ++j) num_ge += __ldcg(&st->counts[j]) >= (unsigned long long)kk;
  const long long new_lo = num_ge > 0 ? mid_of(lo, hi, num_ge - 1) : lo;
  const long long new_hi = num_ge < kT ? mid_of(lo, hi, num_ge) : hi;
  st->lo = new_lo;
  st->hi = new_hi;
  for (int j = 0; j < kT; ++j) st->counts[j] = 0;
  st->ticket = 0;
  if (final_pass) *kth = int(new_lo);
}

// ----------------------------------------------------------------------- emit

__device__ __forceinline__ unsigned emit16(unsigned b, unsigned kth) {
  const unsigned p = pattern16(b);
  return p >= kth && p > 0 ? p : 0u;
}

__device__ __forceinline__ unsigned emit32(unsigned b, unsigned kth) {
  const unsigned p = pattern32(b);
  return p >= kth && p > 0 ? p : 0u;
}

__device__ __forceinline__ uint4 emit_vec(uint4 u, unsigned kth, bool bf16) {
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = bf16 ? emit16(w[e] & 0xFFFFu, kth) | (emit16(w[e] >> 16, kth) << 16)
                : emit32(w[e], kth);
  return u;
}

// One unit a thread: a 16-byte vector when `vec`, else one entry; the tail
// past the last vector goes to the first threads.
template <typename E>
__global__ void __launch_bounds__(kEmitThreads)
batchtopk_emit_kernel(const E* __restrict__ h, E* __restrict__ out, long long n,
                      const int* __restrict__ kth_ptr, int vec) {
  constexpr bool kBf16 = sizeof(E) == 2;
  constexpr int kPer = 16 / sizeof(E);
  const unsigned kth = unsigned(*kth_ptr);
  const long long i = (long long)blockIdx.x * kEmitThreads + threadIdx.x;
  if (vec) {
    const long long nv = n / kPer;
    if (i < nv)
      __stcs(reinterpret_cast<uint4*>(out) + i,
             emit_vec(__ldg(reinterpret_cast<const uint4*>(h) + i), kth, kBf16));
    const long long t = nv * kPer + i;
    if (t < n) out[t] = E(kBf16 ? emit16(h[t], kth) : emit32(h[t], kth));
  } else if (i < n) {
    out[i] = E(kBf16 ? emit16(h[i], kth) : emit32(h[i], kth));
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

long long grid_for(long long units, int threads, long long cap) {
  long long g = (units + threads - 1) / threads;
  if (g > cap) g = cap;
  return g < 1 ? 1 : g;
}

}  // namespace

// bf16 select: `hist` is 32768 zeroed 64-bit words, `ticket` one zeroed word.
extern "C" int batchtopk_select_bf16(const void* h, long long n, long long kk, int vec,
                                     void* hist, void* ticket, void* kth, void* stream) {
  const size_t smem = kBins * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(bt_hist_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  const long long units = vec ? n / 8 : n;
  const int grid = int(grid_for(units, kHistThreads, sm_count()));
  bt_hist_bf16<<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(h), n, kk, vec, static_cast<unsigned long long*>(hist),
      static_cast<unsigned*>(ticket), static_cast<int*>(kth));
  return int(cudaGetLastError());
}

// f32 select: `state` is a BisectState (lo 0, hi 0x7FFFFFFF, the rest 0);
// `n_passes` launches, one bisection pass each.
extern "C" int batchtopk_select_f32(const void* h, long long n, long long kk, int vec,
                                    void* state, void* kth, int n_passes, void* stream) {
  const long long units = vec ? n / 4 : n;
  const int grid = int(grid_for(units, kCountThreads, 8LL * sm_count()));
  for (int p = 0; p < n_passes; ++p) {
    bt_bisect_f32<<<grid, kCountThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(h), n, kk, vec, static_cast<BisectState*>(state),
        static_cast<int*>(kth), int(p == n_passes - 1));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  return 0;
}

extern "C" int batchtopk_emit(const void* h, void* out, long long n, const void* kth,
                              int is_bf16, int vec, void* stream) {
  const long long units = vec ? n / (is_bf16 ? 8 : 4) : n;
  const dim3 grid(unsigned(units > 0 ? (units + kEmitThreads - 1) / kEmitThreads : 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    batchtopk_emit_kernel<uint16_t><<<grid, kEmitThreads, 0, st>>>(
        static_cast<const uint16_t*>(h), static_cast<uint16_t*>(out), n,
        static_cast<const int*>(kth), vec);
  else
    batchtopk_emit_kernel<unsigned><<<grid, kEmitThreads, 0, st>>>(
        static_cast<const unsigned*>(h), static_cast<unsigned*>(out), n,
        static_cast<const int*>(kth), vec);
  return int(cudaGetLastError());
}

// Sparsify drain for Hopper (sm_90a): the <= k nonzeros of each row into
// (vals [R, k], idx [R, k] int32).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/topk_pallas.py
// `_sparsify_kernel` (reached through `sparsify`). Contract kept from it:
// an entry is drained when its value is > 0 (NaN, -0.0 and negatives
// drain nothing); pairs come out in ascending column order; slots past a
// row's count are (0, 0); a row with more than k such entries overwrites
// slot k-1 on every further entry, so slot k-1 ends up holding the row's
// last (highest-column) one. Values are copied bit for bit.
//
// Design. One warp per row streams it front to back, 8 columns a lane
// (one 16-byte load of bf16, two of f32), 256 columns a warp step, with
// the next step's load issued before the current step is drained. Each
// lane makes an 8-bit mask of its positive entries; a warp prefix sum of
// the lanes' popcounts gives every entry its slot, so lanes write their
// own entries with no serialisation. Entries at slot >= k-1 are not
// written in the loop; the warp instead carries the row's last positive
// entry (highest lane with a positive entry, found by a ballot) and
// writes it to slot k-1 once the row is done, which is what the TPU
// kernel's repeated overwrite leaves there.
//
// Bound. The function reads f once (268 MB at [4096, 32768] bf16, 0.08 ms
// at 3.35 TB/s); its writes are [R, k] and negligible.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPB = kThreads / 32;

template <typename T> struct Chunk;   // 8 consecutive elements of a row

template <> struct Chunk<uint16_t> {   // bf16 bit patterns
  union { uint4 u; uint16_t s[8]; } d;
  __device__ __forceinline__ void load(const uint16_t* p) {
    d.u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ bool positive(int j) const {
    return __uint_as_float(unsigned(d.s[j]) << 16) > 0.f;
  }
  __device__ __forceinline__ unsigned bits(int j) const { return d.s[j]; }
};

template <> struct Chunk<float> {
  union { uint4 u[2]; float s[8]; } d;
  __device__ __forceinline__ void load(const float* p) {
    d.u[0] = __ldg(reinterpret_cast<const uint4*>(p));
    d.u[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  __device__ __forceinline__ bool positive(int j) const { return d.s[j] > 0.f; }
  __device__ __forceinline__ unsigned bits(int j) const { return __float_as_uint(d.s[j]); }
};

template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ uint16_t from_bits<uint16_t>(unsigned b) {
  return uint16_t(b);
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& ch, const T* fr, int c, int W, bool vec) {
  if (vec && c + 8 <= W) {
    ch.load(fr + c);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) ch.d.s[j] = c + j < W ? fr[c + j] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparsify_kernel(const T* __restrict__ f, T* __restrict__ vals, int* __restrict__ idx, int R,
                int W, int k, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPB + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* fr = f + size_t(row) * W;
  T* vr = vals + size_t(row) * k;
  int* ir = idx + size_t(row) * k;

  int count = 0;                     // positives drained so far (warp-uniform)
  int last_col = 0;                  // the row's last positive entry so far
  unsigned last_bits = 0;
  Chunk<T> cur, nxt;
  load_chunk(cur, fr, lane * 8, W, vec);
  for (int base = 0; base < W; base += 256) {
    const int c = base + lane * 8;
    if (base + 256 < W) load_chunk(nxt, fr, c + 256, W, vec);
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) m |= unsigned(c + j < W && cur.positive(j)) << j;
    const int n = __popc(m);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int pos = count + incl - n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if ((m >> j) & 1u) {
        if (pos < k - 1) {
          vr[pos] = from_bits<T>(cur.bits(j));
          ir[pos] = c + j;
        }
        ++pos;
      }
    }
    const unsigned any = __ballot_sync(0xffffffffu, n > 0);
    if (any) {
      const int src = 31 - __clz(any);
      const int jh = m ? 31 - __clz(m) : 0;
      last_col = __shfl_sync(0xffffffffu, c + jh, src);
      last_bits = __shfl_sync(0xffffffffu, cur.bits(jh), src);
    }
    count += __shfl_sync(0xffffffffu, incl, 31);
    cur = nxt;
  }
  if (count >= k) {
    if (lane == 0) {
      vr[k - 1] = from_bits<T>(last_bits);
      ir[k - 1] = last_col;
    }
  } else {
    for (int s = count + lane; s < k; s += 32) {
      vr[s] = T(0);
      ir[s] = 0;
    }
  }
}

template <typename T>
int launch(const void* f, void* vals, void* idx, int R, int W, int k, int vec,
           cudaStream_t stream) {
  const int blocks = (R + kRowsPB - 1) / kRowsPB;
  sparsify_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<T*>(vals), static_cast<int*>(idx), R, W, k, vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int sparsify_launch(const void* f, void* vals, void* idx, int R, int W, int k,
                               int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<uint16_t>(f, vals, idx, R, W, k, vec, st);
  return launch<float>(f, vals, idx, R, W, k, vec, st);
}

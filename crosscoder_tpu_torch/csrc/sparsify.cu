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
// Bound. The function reads f once (268 MB at [4096, 32768] bf16, 0.08 ms
// at 3.35 TB/s); its writes are [R, k] and negligible. A row holds few
// positives (k of 32768 on the main path), so the kernel is a stream of
// loads with almost nothing to do per entry.
//
// Design. A row is cut into P parts of S columns (S a multiple of 8; P in
// {1, 2, 4, 8}, chosen by the wrapper from the row's bytes), one warp a
// part, 8 / P rows a 256-thread block, so a 4096-row batch fills the card
// with warps. A warp streams its part front to back in steps of kU chunks
// of 8 entries a lane (kU x 256 columns; 64 bytes a lane in bf16 and in
// f32), the next step's loads issued before this step is examined, each a
// 16-byte load that skips L1 and asks L2 for its whole 256-byte line. A
// step first tests all its entries for > 0 on their bit patterns (two
// bf16 at a time); only a step where some lane holds a positive is
// drained. There each chunk with a positive makes an 8-bit mask a lane, a
// warp prefix sum of the lanes' popcounts gives every entry its rank in
// the part, and lanes write their own entries with ranks below k-1; the
// warp carries its part's last positive entry (highest lane with one, by
// a ballot).
//   P = 1 (the "warp" route, any k): ranks are slots, entries go straight
// to the output, and the warp writes the row's last entry to slot k-1 (if
// the row has k or more) or pads its tail with (0, 0).
//   P > 1 (the "split" route, k <= the wrapper's staging limit): each warp
// stages its first k-1 entries in shared memory; after a block barrier
// each warp reads its row's part counts, offsets its entries by the count
// of the lower parts and copies those that land below slot k-1; the
// highest part with a positive supplies slot k-1 when the row has k or
// more, and the parts share the padding otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// a 16-byte load that skips L1 and asks L2 for the whole 256-byte line
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

template <typename T> struct Chunk;   // 8 consecutive elements of a row

template <> struct Chunk<uint16_t> {   // bf16 bit patterns
  static constexpr int kU = 4;         // chunks a lane a step: 4 16-byte loads
  union { uint4 u; uint16_t s[8]; } d;
  __device__ __forceinline__ void load(const uint16_t* p) {
    d.u = ldg16(p);
  }
  // nonzero iff some entry is > 0: a pattern in [0x0001, 0x7F80]
  __device__ __forceinline__ unsigned any_positive() const {
    const unsigned w[4] = {d.u.x, d.u.y, d.u.z, d.u.w};
    unsigned hit = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) hit |= __vcmpltu2(__vsub2(w[i], 0x00010001u), 0x7F807F80u);
    return hit;
  }
  __device__ __forceinline__ bool positive(int j) const {
    return ((unsigned(d.s[j]) + 0xFFFFu) & 0xFFFFu) < 0x7F80u;
  }
  __device__ __forceinline__ unsigned bits(int j) const { return d.s[j]; }
};

template <> struct Chunk<float> {
  static constexpr int kU = 2;         // chunks a lane a step: 4 16-byte loads
  union { uint4 u[2]; float s[8]; unsigned b[8]; } d;
  __device__ __forceinline__ void load(const float* p) {
    d.u[0] = ldg16(p);
    d.u[1] = ldg16(p + 4);
  }
  // a pattern in [0x00000001, 0x7F800000] is > 0
  __device__ __forceinline__ unsigned any_positive() const {
    unsigned hit = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) hit |= unsigned(d.b[j] - 1u < 0x7F800000u);
    return hit;
  }
  __device__ __forceinline__ bool positive(int j) const { return d.b[j] - 1u < 0x7F800000u; }
  __device__ __forceinline__ unsigned bits(int j) const { return d.b[j]; }
};

template <typename T> __device__ __forceinline__ T from_bits(unsigned b);
template <> __device__ __forceinline__ uint16_t from_bits<uint16_t>(unsigned b) {
  return uint16_t(b);
}
template <> __device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

// bits(j) at a j known only at run time, without indexing the registers
template <typename T>
__device__ __forceinline__ unsigned bits_at(const Chunk<T>& ch, int j) {
  unsigned b = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) b = i == j ? ch.bits(i) : b;
  return b;
}

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& ch, const T* fr, int c, int end, bool vec) {
  if (vec && c + 8 <= end) {
    ch.load(fr + c);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) ch.d.s[j] = c + j < end ? fr[c + j] : T(0);
  }
}

// The drain of one part [c0, end) of a row by one warp. Entries of rank r
// < k-1 in the part go to sink(r, col, bits); returns the part's count of
// positives and its last one in (last_col, last_bits).
template <typename T, typename Sink>
__device__ __forceinline__ int drain_part(const T* fr, int c0, int end, int k, bool vec,
                                          Sink sink, int& last_col, unsigned& last_bits) {
  constexpr int kU = Chunk<T>::kU;
  const int lane = threadIdx.x & 31;
  int count = 0;                       // positives drained so far (warp-uniform)
  Chunk<T> cur[kU], nxt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) load_chunk(cur[u], fr, c0 + u * 256 + lane * 8, end, vec);
  for (int base = c0; base < end; base += kU * 256) {
    const int next = base + kU * 256;
    if (next < end) {
#pragma unroll
      for (int u = 0; u < kU; ++u) load_chunk(nxt[u], fr, next + u * 256 + lane * 8, end, vec);
    }
    unsigned hit = 0;
#pragma unroll
    for (int u = 0; u < kU; ++u) hit |= cur[u].any_positive();
    if (__any_sync(kFull, hit != 0)) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = base + u * 256 + lane * 8;
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) m |= unsigned(c + j < end && cur[u].positive(j)) << j;
        const unsigned any = __ballot_sync(kFull, m != 0);
        if (!any) continue;
        const int n = __popc(m);
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        int pos = count + incl - n;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((m >> j) & 1u) {
            if (pos < k - 1) sink(pos, c + j, cur[u].bits(j));
            ++pos;
          }
        }
        const int src = 31 - __clz(any);
        const int jh = m ? 31 - __clz(m) : 0;
        last_col = __shfl_sync(kFull, c + jh, src);
        last_bits = __shfl_sync(kFull, bits_at(cur[u], jh), src);
        count += __shfl_sync(kFull, incl, 31);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
  return count;
}

// P = 1: a warp a row, entries straight to the output; any k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sparsify_warp_kernel(const T* __restrict__ f, T* __restrict__ vals, int* __restrict__ idx, int R,
                     int W, int k, int vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* fr = f + size_t(row) * W;
  T* vr = vals + size_t(row) * k;
  int* ir = idx + size_t(row) * k;
  int last_col = 0;
  unsigned last_bits = 0;
  const int count = drain_part<T>(
      fr, 0, W, k, vec,
      [&](int pos, int col, unsigned b) {
        vr[pos] = from_bits<T>(b);
        ir[pos] = col;
      },
      last_col, last_bits);
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

// P > 1: P warps a row, each staging its part's first k-1 entries in
// shared memory ([kWarps][k-1] bit patterns, then as many columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sparsify_split_kernel(const T* __restrict__ f, T* __restrict__ vals, int* __restrict__ idx,
                      int R, int W, int k, int vec, int P, int S) {
  extern __shared__ __align__(16) unsigned stage[];
  __shared__ int cnt[kWarps];
  __shared__ int lcol[kWarps];
  __shared__ unsigned lbits[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (kWarps / P) + warp / P;
  const int part = warp % P;
  const int cap = k - 1;
  unsigned* sb = stage + size_t(warp) * cap;
  int* sc = reinterpret_cast<int*>(stage + size_t(kWarps) * cap) + size_t(warp) * cap;
  int count = 0, last_col = 0;
  unsigned last_bits = 0;
  if (row < R) {
    const int c0 = min(part * S, W);
    count = drain_part<T>(
        f + size_t(row) * W, c0, min(c0 + S, W), k, vec,
        [&](int pos, int col, unsigned b) {
          sb[pos] = b;
          sc[pos] = col;
        },
        last_col, last_bits);
  }
  if (lane == 0) {
    cnt[warp] = count;
    lcol[warp] = last_col;
    lbits[warp] = last_bits;
  }
  __syncthreads();
  if (row >= R) return;
  const int w0 = warp - part;          // the row's first warp
  int before = 0, total = 0, top = -1;
  for (int q = 0; q < P; ++q) {
    const int c = cnt[w0 + q];
    before += q < part ? c : 0;
    total += c;
    top = c > 0 ? q : top;
  }
  T* vr = vals + size_t(row) * k;
  int* ir = idx + size_t(row) * k;
  const int n = min(count, cap - before);
  for (int i = lane; i < n; i += 32) {
    vr[before + i] = from_bits<T>(sb[i]);
    ir[before + i] = sc[i];
  }
  if (total >= k) {
    if (part == top && lane == 0) {
      vr[k - 1] = from_bits<T>(last_bits);
      ir[k - 1] = last_col;
    }
  } else {
    for (int s = total + part * 32 + lane; s < k; s += 32 * P) {
      vr[s] = T(0);
      ir[s] = 0;
    }
  }
}

template <typename T>
int launch(const void* f, void* vals, void* idx, int R, int W, int k, int vec, int P, int S,
           cudaStream_t stream) {
  if (R == 0) return 0;
  const T* fp = static_cast<const T*>(f);
  T* vp = static_cast<T*>(vals);
  int* ip = static_cast<int*>(idx);
  if (P == 1) {
    sparsify_warp_kernel<T><<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(fp, vp, ip, R, W,
                                                                                k, vec);
  } else {
    if (P < 1 || kWarps % P || k < 2) return int(cudaErrorInvalidValue);
    const int rows_pb = kWarps / P;
    const size_t smem = size_t(kWarps) * (k - 1) * 8;
    sparsify_split_kernel<T><<<(R + rows_pb - 1) / rows_pb, kThreads, smem, stream>>>(
        fp, vp, ip, R, W, k, vec, P, S);
  }
  return int(cudaGetLastError());
}

}  // namespace

// P: parts a row (1: the warp route; 2, 4 or 8: the split route, k >= 2
// and 8 x (k-1) x 8 bytes of shared memory); S: columns a part.
extern "C" int sparsify_launch(const void* f, void* vals, void* idx, int R, int W, int k,
                               int is_bf16, int vec, int P, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<uint16_t>(f, vals, idx, R, W, k, vec, P, S, st);
  return launch<float>(f, vals, idx, R, W, k, vec, P, S, st);
}

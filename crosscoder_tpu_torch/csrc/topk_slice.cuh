// The per-row TopK mask of rows held in on-chip shared memory, for Hopper
// (sm_90a). One template serves K5 (topk_mask.cu: bf16 rows up to 2^16
// wide, one block a row) and the cluster route of K7 (topk_chunked.cu:
// bf16 or f32 rows cut into at most eight slices, one thread-block cluster
// a row). For bf16 the two compute the same function.
//
// Keys, as topk_chunked.cu's header sets them out: a bf16 entry's key is
// K5's clamped 15-bit pattern (sign-set patterns 0 unless a negative NaN,
// which maps to 0x7FFE; positive patterns clamped at 0x7FFE), an f32
// entry's its pattern when the sign bit is clear, else 0. kth is the k-th
// largest key clamped below top - 1 (0 when fewer than k keys are
// nonzero); every key above kth is kept, and the lowest-column k - count(>
// kth) keys equal to it, where count(> kth) is taken as 0 when kth is top -
// 1 (f32 only, ROADMAP C6). The value written is the key.
//
// Design. A row is cut into C slices of S columns (S a multiple of 8, the
// last slice possibly shorter), one a block of a cluster of C blocks (C =
// 1: a plain block, its barriers block-wide). Each block
//
// 1. loads its slice from device memory into its shared memory once, with
//    kLoadChunks 1-D bulk copies (cp.async.bulk), each completing on its
//    own mbarrier, when the row is 16-byte aligned, else with a plain loop;
//    bf16 stays 16 bits a column, so a 64 KB slice is 32768 bf16 or 16384
//    f32 columns;
// 2. runs radix_select.cuh's select over its slice: bf16 in up to two
//    passes (bits 14-8, 7-0), f32 in up to four. The first pass counts
//    each chunk as its copy completes, so the load overlaps it, and turns
//    the entries into keys in place. Each pass counts the block's slice
//    into its own shared histogram, a cluster barrier publishes it, and
//    every block sums the bins of all C blocks through distributed shared
//    memory (mapa + ld.shared::cluster): the counts are integers, so all
//    reach the same digit and the same early exit. Two histogram buffers
//    alternate by pass, so one cluster barrier a pass suffices: a buffer is
//    zeroed again only after every block has passed the barrier that
//    follows its last reads of it;
// 3. emits its slice with 16-byte stores, one compare a column: every key
//    above kth, and the ties at kth up to a column cstar. cstar is the
//    slice's end when every tie is kept (the common case, and always when
//    kth is 0); else the slice keeps the ties left after those of the
//    lower slices (each block's tie count, published to the cluster), and
//    cstar is the column of the last of them, found from per-stretch tie
//    counts and one block scan over the stretch that holds it.
//
// A block leaves only after the cluster's last barrier, so no block's
// shared memory goes while another may still read it.
//
// Bound. The function reads the row once and writes it once, and so does
// this design: device memory sees one bulk read and one 16-byte-store
// write of each slice; the select passes and the emit's reads run out of
// shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_select.cuh"
#include "sm90_sync.cuh"

namespace tslice {

using radix::kBins;
using radix::kThreads;
using radix::kWarps;

constexpr int kLoadChunks = 4;                   // bulk copies a slice, each on its own mbarrier
constexpr int kMaxCluster = 8;                   // the portable cluster size
constexpr int kMaxStretches = 16;                // stretches of kThreads * 8 columns a slice
constexpr int kMaxSlice = kMaxStretches * kThreads * 8;   // columns a block takes (65536)
constexpr int kNoCluster = -1;                   // launch code: no such cluster fits an SM

__device__ __forceinline__ unsigned key_bf16(unsigned p) {
  if (p >= 0x8000u) return p > 0xFF80u ? 0x7FFEu : 0u;
  return p < 0x7FFEu ? p : 0x7FFEu;
}

__device__ __forceinline__ unsigned key_f32(unsigned b) { return (b & 0x80000000u) ? 0u : b; }

// A dtype's entries: keys8 reads the keys of the 8 columns of group g of a
// slice of entries in shared memory, put8 writes keys back in their place
// and raw8 reads them again; store8 writes 8 values at column c of a slice
// of n columns in device memory (16-byte stores when vec).
template <bool BF16>
struct Row;

template <>
struct Row<true> {
  using T = uint16_t;
  static constexpr unsigned kTopM1 = 0x7FFFu;   // top - 1: keys clamp here
  static constexpr int kFirstShift = 8;

  static __device__ __forceinline__ void raw8(const T* sl, int g, unsigned* key) {
    union { uint4 u; uint16_t s[8]; } d;
    d.u = reinterpret_cast<const uint4*>(sl)[g];
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = d.s[j];
  }

  static __device__ __forceinline__ void keys8(const T* sl, int g, unsigned* key) {
    raw8(sl, g, key);
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = key_bf16(key[j]);
  }

  static __device__ __forceinline__ void put8(T* sl, int g, const unsigned* key) {
    union { uint4 u; uint16_t s[8]; } d;
#pragma unroll
    for (int j = 0; j < 8; ++j) d.s[j] = uint16_t(key[j]);
    reinterpret_cast<uint4*>(sl)[g] = d.u;
  }

  static __device__ __forceinline__ void store8(T* r, int c, int n, int vec, const unsigned* o) {
    if (vec) {
      union { uint4 u; uint16_t s[8]; } d;
#pragma unroll
      for (int j = 0; j < 8; ++j) d.s[j] = uint16_t(o[j]);
      *reinterpret_cast<uint4*>(r + c) = d.u;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < n) r[c + j] = uint16_t(o[j]);
    }
  }
};

template <>
struct Row<false> {
  using T = unsigned;
  static constexpr unsigned kTopM1 = 0x7F800000u;
  static constexpr int kFirstShift = 24;

  static __device__ __forceinline__ void raw8(const T* sl, int g, unsigned* key) {
    const uint4 a = reinterpret_cast<const uint4*>(sl)[2 * g];
    const uint4 b = reinterpret_cast<const uint4*>(sl)[2 * g + 1];
    key[0] = a.x; key[1] = a.y; key[2] = a.z; key[3] = a.w;
    key[4] = b.x; key[5] = b.y; key[6] = b.z; key[7] = b.w;
  }

  static __device__ __forceinline__ void keys8(const T* sl, int g, unsigned* key) {
    raw8(sl, g, key);
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = key_f32(key[j]);
  }

  static __device__ __forceinline__ void put8(T* sl, int g, const unsigned* key) {
    reinterpret_cast<uint4*>(sl)[2 * g] = make_uint4(key[0], key[1], key[2], key[3]);
    reinterpret_cast<uint4*>(sl)[2 * g + 1] = make_uint4(key[4], key[5], key[6], key[7]);
  }

  static __device__ __forceinline__ void store8(T* r, int c, int n, int vec, const unsigned* o) {
    if (vec) {
      *reinterpret_cast<uint4*>(r + c) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(r + c + 4) = make_uint4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c + j < n) r[c + j] = o[j];
    }
  }
};

// A cluster's histogram of a select pass (radix_select.cuh's BlockHist
// across blocks): each block counts its slice into its buffer of the pass,
// a cluster barrier publishes every block's, and total() sums bin b over
// every block's copies.
struct ClusterHist {
  unsigned* hist;        // 2 * kBins, shared
  unsigned n_blocks;
  __device__ __forceinline__ unsigned* buffer(int pass) const { return hist + (pass & 1) * kBins; }
  __device__ __forceinline__ void publish() const { sm90::cluster_sync(); }
  __device__ __forceinline__ int total(int pass, int b) const {
    const unsigned* bin = buffer(pass) + b;
    int c = 0;
    for (unsigned r = 0; r < n_blocks; ++r) c += int(sm90::ld_cluster(sm90::cluster_map(bin, r)));
    return c;
  }
};

// A block's shared scratch for mask_slice.
template <bool kCluster>
struct Scratch {
  unsigned hist[(kCluster ? 2 : 1) * kBins];
  int stretch[kMaxStretches];                      // ties at kth a stretch of the slice
  int cstar;                                       // the column of the last tie kept
  int ws[2 * kWarps];
  int sel[3];
  int ties;                                        // this block's ties at kth
};

// A slice still arriving: chunk i (groups [i * groups, (i + 1) * groups)
// of 8 columns) is in shared memory once bar[i] completes its phase 0.
// bar = nullptr: the whole slice is there.
struct Arrival {
  uint64_t* bar;
  int groups;
};

// The select and the emit of one slice of a row: `slice` in shared memory
// (n columns, zero-padded to a multiple of 8, arriving as `arrival` says),
// `dst` its place in device memory. The slice is block `rank` of a cluster
// of C (C = 1: no cluster). The first select pass counts each chunk as it
// arrives, so the load overlaps it. Returns after the block's last barrier
// of the row.
template <bool BF16, bool kCluster>
__device__ __forceinline__ void mask_slice(typename Row<BF16>::T* slice,
                                           typename Row<BF16>::T* dst, int n, int k, int vec,
                                           unsigned rank, unsigned C, Scratch<kCluster>& sc,
                                           Arrival arrival) {
  using R = Row<BF16>;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n8 = (n + 7) / 8;
  if (tid < kMaxStretches) sc.stretch[tid] = 0;

  // ---- select: each pass counts this slice; the cluster sums the bins.
  // The first pass turns the slice's entries into keys in place, so the
  // later passes and the emit read keys.
  auto count = [&](int shift, unsigned mask, unsigned prefix, unsigned* hist) {
    const bool first = shift == R::kFirstShift;
    int arrived = arrival.bar && first ? 0 : n8;   // groups known to be here
    for (int g0 = 0, chunk = 0; g0 < n8; g0 += kThreads) {
      while (arrived < min(g0 + kThreads, n8)) {   // every thread waits for every chunk
        sm90::mbar_wait(&arrival.bar[chunk++], 0);
        arrived += arrival.groups;
      }
      const int g = g0 + tid;
      if (g >= n8) continue;
      unsigned key[8];
      if (first) {
        R::keys8(slice, g, key);
        R::put8(slice, g, key);
      } else {
        R::raw8(slice, g, key);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        radix::count_key(min(key[j], R::kTopM1), shift, mask, prefix, hist);
    }
  };
  radix::Select s;
  if constexpr (kCluster)
    s = radix::radix_select_over<R::kFirstShift, 1>(k, ClusterHist{sc.hist, C}, sc.ws, sc.sel,
                                                    count);
  else
    s = radix::radix_select<R::kFirstShift, 1>(k, sc.hist, sc.ws, sc.sel, count);
  const unsigned kth = s.kth;
  // ties to keep: k - count(> kth), where count(> kth) is taken as 0 at top - 1
  const int need = kth == R::kTopM1 ? k : s.need;

  // ---- emit: every key above kth, and the ties at kth up to column cstar
  // of this slice
  int cstar = n;                                   // every tie kept
  if (kth != 0u && need < s.eq) {
    // some ties dropped (eq counts the clamped keys in kth's bin, a
    // superset of the ties): this slice keeps the lowest-column `keep` of
    // its own, need less the ties of the lower slices. Count its ties by
    // stretch of kThreads groups, one atomic a warp and stretch.
    for (int g0 = 0, st = 0; g0 < n8; g0 += kThreads, ++st) {
      const int g = g0 + tid;
      int t = 0;
      if (g < n8) {
        unsigned key[8];
        R::raw8(slice, g, key);
#pragma unroll
        for (int j = 0; j < 8; ++j) t += key[j] == kth;
      }
      t = __reduce_add_sync(0xffffffffu, t);
      if (lane == 0 && t != 0) atomicAdd(&sc.stretch[st], t);
    }
    __syncthreads();
    const int n_st = (n8 + kThreads - 1) / kThreads;
    int mine = 0;
    for (int st = 0; st < n_st; ++st) mine += sc.stretch[st];
    int keep = need;
    if constexpr (kCluster) {
      if (tid == 0) sc.ties = mine;
      sm90::cluster_sync();
      for (unsigned r = 0; r < rank; ++r)
        keep -= int(sm90::ld_cluster(sm90::cluster_map(&sc.ties, r)));
    }
    if (keep <= 0) {
      cstar = -1;
    } else if (keep < mine) {
      // the stretch that holds the keep-th tie, then a block scan over it
      int st = 0, acc = 0;
      while (acc + sc.stretch[st] < keep) acc += sc.stretch[st++];
      const int g = st * kThreads + tid;
      unsigned key[8];
      int t = 0;
      if (g < n8) {
        R::raw8(slice, g, key);
#pragma unroll
        for (int j = 0; j < 8; ++j) t += key[j] == kth;
      }
      int tot;
      int r = acc + radix::block_excl_scan(t, sc.ws, 0, &tot);
      if (r < keep && keep <= r + t) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (key[j] == kth && ++r == keep) sc.cstar = g * 8 + j;
      }
      __syncthreads();
      cstar = sc.cstar;
    }
  }
  if (kCluster) sm90::cluster_arrive();   // this block reads no other's shared memory again
  for (int g = tid; g < n8; g += kThreads) {
    unsigned key[8];
    R::raw8(slice, g, key);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      key[j] = key[j] > kth || (key[j] == kth && g * 8 + j <= cstar) ? key[j] : 0u;
    R::store8(dst, g * 8, n, vec, key);
  }
  if (kCluster) sm90::cluster_wait();
}

// Rows of W columns; block `rank` of a row's cluster takes columns
// [rank * S, rank * S + S) (the grid is C blocks a row, consecutive).
template <bool BF16, bool kCluster>
__global__ void __launch_bounds__(kThreads)
topk_slice_kernel(const void* __restrict__ h, void* __restrict__ out, int W, int S, int k,
                  int vec) {
  using T = typename Row<BF16>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* slice = reinterpret_cast<T*>(smem);           // the slice, zero-padded to 8 columns
  __shared__ Scratch<kCluster> sc;
  __shared__ __align__(8) uint64_t bar[kLoadChunks];
  const int tid = threadIdx.x;
  const unsigned C = kCluster ? sm90::cluster_size() : 1u;
  const unsigned rank = kCluster ? sm90::cluster_rank() : 0u;
  const size_t row = blockIdx.x / C;
  const int c0 = int(rank) * S;
  const int n = max(0, min(S, W - c0));            // this slice's columns
  const T* src = static_cast<const T*>(h) + row * size_t(W) + c0;

  // load: kLoadChunks bulk copies (vec: n is a multiple of 8, the row
  // 16-byte aligned), waited for chunk by chunk in the first select pass;
  // else a plain loop
  Arrival arrival{nullptr, 0};
  if (vec) {
    const int groups = (n / 8 + kLoadChunks - 1) / kLoadChunks;
    if (tid == 0) {
      for (int i = 0; i < kLoadChunks; ++i) sm90::mbar_init(&bar[i], 1);
      sm90::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < kLoadChunks; ++i) {
        const int g0 = min(i * groups, n / 8), g1 = min(g0 + groups, n / 8);
        const uint32_t bytes = uint32_t(g1 - g0) * 8u * uint32_t(sizeof(T));
        sm90::mbar_expect_tx(&bar[i], bytes);
        if (bytes != 0)
          sm90::bulk_load(slice + size_t(g0) * 8, src + size_t(g0) * 8, bytes, &bar[i]);
      }
    }
    arrival = Arrival{bar, groups};
  } else {
    for (int i = tid; i < (n + 7) / 8 * 8; i += kThreads) slice[i] = i < n ? src[i] : T(0);
    __syncthreads();
  }
  mask_slice<BF16, kCluster>(slice, static_cast<T*>(out) + row * size_t(W) + c0, n, k, vec, rank,
                             C, sc, arrival);
}

// R rows of W columns, C blocks a row of S columns each (S a multiple of
// 8, C * S >= W): C = 1 launches plain blocks, C > 1 clusters of C blocks,
// after cudaOccupancyMaxActiveClusters has found room for one (kNoCluster
// otherwise). Returns a CUDA error code, 0 on success.
template <bool BF16>
inline int launch(const void* h, void* out, int R, int W, int S, int C, int k, int vec,
                  cudaStream_t stream) {
  if (R == 0 || W == 0) return 0;
  if (S > kMaxSlice) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(S) * (BF16 ? 2 : 4);
  if (C == 1) {
    cudaError_t err = cudaFuncSetAttribute(topk_slice_kernel<BF16, false>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    topk_slice_kernel<BF16, false><<<R, kThreads, smem, stream>>>(h, out, W, S, k, vec);
    return int(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(topk_slice_kernel<BF16, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(C) * unsigned(R));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, topk_slice_kernel<BF16, true>, &cfg);
  if (err != cudaSuccess) return int(err);
  if (clusters == 0) return kNoCluster;
  err = cudaLaunchKernelEx(&cfg, topk_slice_kernel<BF16, true>, h, out, W, S, k, vec);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace tslice

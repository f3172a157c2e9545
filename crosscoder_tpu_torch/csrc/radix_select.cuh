// The radix select and the column-ordered tie emit shared by the row TopK
// mask kernels: topk_mask_f32.cu (K6, a row staged in shared memory),
// topk_slice.cuh (K5 and K7's cluster route, a row in the shared memory of
// one block or of a cluster's blocks) and topk_chunked.cu (K7's streaming
// route, a row read from device memory). Each kernel brings its own keys,
// where they are read from and how they are written back.
//
// Keys are unsigned and a key of 0 is never selected. The select finds kth,
// the k-th largest key of a row, over 8-bit digits from kFirstShift down:
// a pass builds a 256-bin histogram of one digit of the nonzero keys that
// match the digits chosen so far, then a suffix scan over the bins picks the
// digit that holds the k-th largest. Counts are integers, so the result does
// not depend on the order the atomics land in. A pass whose chosen bin is
// kept whole ends the select early.

#pragma once

#include <cuda_runtime.h>

namespace radix {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;

// Exclusive block prefix sum of v; *total gets the block's sum. `ws` holds
// two buffers of kWarps slots used alternately (`parity`), so a call never
// overwrites a buffer that a thread may still be reading from the call
// before.
__device__ __forceinline__ int block_excl_scan(int v, int* ws, int parity, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) ws[parity * kWarps + warp] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int s = ws[parity * kWarps + w];
    tot += s;
    off += w < warp ? s : 0;
  }
  *total = tot;
  return off + incl - v;
}

// One key's share of a select pass's histogram.
__device__ __forceinline__ void count_key(unsigned v, int shift, unsigned mask, unsigned prefix,
                                          unsigned* hist) {
  if (v != 0u && (v & mask) == prefix) atomicAdd(&hist[(v >> shift) & 0xFFu], 1u);
}

struct Select {
  unsigned kth;  // the k-th largest key (0: fewer than k nonzero keys)
  int need;      // keys equal to kth to keep, lowest columns first
  int eq;        // keys in kth's last chosen bin: every tie, and at most
                 // `need` others when the select ended early
};

// One block's histogram of a select pass: kCopies copies of kBins bins
// (warp % kCopies spreads the shared-memory atomics), summed by the block.
// `buffer(pass)` is where a pass counts; `publish()` makes the counts
// visible to every thread that sums them; `total(pass, b)` is bin b's count.
template <int kCopies>
struct BlockHist {
  unsigned* hist;   // kCopies * kBins, shared
  __device__ __forceinline__ unsigned* buffer(int) const { return hist; }
  __device__ __forceinline__ void publish() const { __syncthreads(); }
  __device__ __forceinline__ int total(int, int b) const {
    int c = 0;
#pragma unroll
    for (int s = 0; s < kCopies; ++s) c += int(hist[s * kBins + b]);
    return c;
  }
};

// The select over one row. `count(shift, mask, prefix, hist)` adds each of
// the row's keys to `hist` with count_key; `hist` is one of the kCopies
// copies of the pass's buffer (warp % kCopies). `hs` is a BlockHist or a
// histogram summed over more than one block (topk_slice.cuh); every block
// that sums the same counts takes the same digits and the same exits.
// `ws` (2 * kWarps) and `sel` (3) are shared.
template <int kFirstShift, int kCopies, class Hist, class Count>
__device__ Select radix_select_over(int k, const Hist& hs, int* ws, int* sel, Count count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, mask = 0;
  int remaining = k, eq = 0;
  for (int shift = kFirstShift, pass = 0; shift >= 0; shift -= 8, ++pass) {
    unsigned* hist = hs.buffer(pass);
    for (int i = tid; i < kCopies * kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    count(shift, mask, prefix, hist + (warp % kCopies) * kBins);
    hs.publish();
    // threads 0..255 take the bins in descending order: an inclusive scan
    // over them is the count of matching keys whose digit is >= the bin
    int c = 0, incl = 0;
    const int b = kBins - 1 - tid;
    if (tid < kBins) {
      c = hs.total(pass, b);
      incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) ws[warp] = incl;
    }
    __syncthreads();
    int total = 0, off = 0;
#pragma unroll
    for (int w = 0; w < kBins / 32; ++w) {
      total += ws[w];
      off += w < warp ? ws[w] : 0;
    }
    if (shift == kFirstShift && total < k) {     // fewer than k nonzero keys
      __syncthreads();
      return Select{0u, 0, 0};
    }
    if (tid < kBins) {
      const int ge = off + incl, gt = ge - c;
      if (gt < remaining && ge >= remaining) {
        sel[0] = b;
        sel[1] = gt;
        sel[2] = c;
      }
    }
    __syncthreads();
    prefix |= unsigned(sel[0]) << shift;
    mask |= 0xFFu << shift;
    remaining -= sel[1];
    eq = sel[2];
    __syncthreads();
    if (remaining == eq) break;      // the whole bin is kept: kth = its lowest key's
                                     // digits so far, every tie kept
  }
  return Select{prefix, remaining, eq};
}

// The select over one block's row, its histogram in `hist` (kCopies *
// kBins, shared).
template <int kFirstShift, int kCopies, class Count>
__device__ Select radix_select(int k, unsigned* hist, int* ws, int* sel, Count count) {
  return radix_select_over<kFirstShift, kCopies>(k, BlockHist<kCopies>{hist}, ws, sel, count);
}

// The emit when some ties at kth are dropped: keeps every key above kth and
// the first `need` keys equal to it in column order, zeroes the rest. A
// block prefix count of the ties of each stretch of kThreads * G columns is
// carried across stretches. `load(c, key)` fills key[0, G) with the keys of
// columns [c, c + G) (c < W); `store(c, key)` writes them back.
template <int G, class Load, class Store>
__device__ void emit_ties(int W, unsigned kth, int need, int* ws, Load load, Store store) {
  int carried = 0, parity = 0;
  for (int s0 = 0; s0 < W; s0 += kThreads * G) {
    const int c = s0 + threadIdx.x * G;
    unsigned key[G];
    int t = 0;
    if (c < W) {
      load(c, key);
#pragma unroll
      for (int j = 0; j < G; ++j) t += key[j] == kth;
    }
    int tot;
    int rank = carried + block_excl_scan(t, ws, parity, &tot);
    parity ^= 1;
    if (c < W) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (key[j] == kth) {
          key[j] = rank < need ? key[j] : 0u;
          ++rank;
        } else if (key[j] < kth) {
          key[j] = 0u;
        }
      }
      store(c, key);
    }
    carried += tot;
  }
}

}  // namespace radix

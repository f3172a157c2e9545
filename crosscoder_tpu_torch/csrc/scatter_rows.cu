// Sorted-pair scatter-accumulate for Hopper (sm_90a):
// out[dst[p], :] += cf[p] * rows[src[p], :] over pairs sorted by dst.
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/sparse_grad.py
// `_scatter_rows_kernel` (reached through `scatter_add_rows`). As there,
// the pair list is sorted by destination (stably, so a destination's pairs
// keep their batch-major order) in PyTorch before the launch; pairs whose
// destination is out of range carry the sentinel dst = n_out and lie past
// every item, so they are dropped. Sums are f32.
//
// The function and its order. Each element of out is
// acc = __fadd_rn(acc, __fmul_rn(c, r)) over its destination's pairs in
// sorted order, from 0, zero coefficients included (0 * inf and -0.0 come
// out as the plain version's). The rounded intrinsics keep the compiler
// from contracting an FMA, so the result is bitwise the plain version's
// (out[d] = out[d] + c * r, rank by rank). One thread walks one
// (destination, column) chain, in order; every element of out is written
// exactly once, by one thread, with no atomics.
//
// Bound. The main shape (the dW_dec and dW_enc scatters of a TopK step,
// 4096 x 32 random pairs onto [32768, 4608] f32) writes out once (604 MB)
// and reads rows (75 MB) and the pairs once: 0.20 ms at 3.35 TB/s, by
// bytes. The AuxK shape (leg F: 4096 x 64 pairs onto [16384, 4608] f32)
// is 0.11 ms by the same count. What this kernel moves beyond the bound is
// one source-row slice per pair from L2 (rows fit in the 50 MB L2): 2.4 GB
// at the main shape, 4.8 GB at the AuxK shape.
//
// The AuxK shape is crowded: when fewer than aux_k latents are dead, every
// batch row sends a pair to each dead latent and to each of the lowest
// live columns that fill its remaining slots (exact ranking, ties to the
// lowest index), so 64 destinations take 4096 pairs each, inside two
// 32-row blocks. A design that gives each 32-row block of out one walk
// runs 4096 x 64 dependent L2 round trips on 18 blocks.
//
// Design.
// 1. A work list in place of fixed row blocks, sized by a bound that the
//    shapes fix (ops/sparse_grad.py `work_list_bound`): a cold item is a
//    run of at most 32 destination rows with fewer than 2 x 256 pairs; a
//    destination with more than 256 pairs is a hot item of its own. Hot
//    items come first, then cold ones, each in row order; the unused tail
//    is empty and its blocks exit at once. The grid is (items, 512-column
//    slices), so the 64 hot destinations of the AuxK shape are 576 blocks
//    over all 132 SMs. Three small kernels here build the list on the
//    device with no host sync (a binary search for each row's first pair;
//    each tile of 1024 rows counts the items that start in it; each tile
//    scans its counts after those of the tiles before it and writes its
//    items), the same list as the plain PyTorch `work_list_plain`: built
//    from some twenty PyTorch operations, the list cost the wrapper more
//    host time than the card spent in the scatter.
// 2. Loads in flight. Each thread stages the source-row slices of its next
//    kS - 1 pairs in a ring of kS slots in shared memory with cp.async
//    (16 bytes of 4 f32 columns, 8 of 4 bf16), one commit group a pair, so
//    an SM keeps thousands of row loads in flight, not one a thread. A
//    thread reads only the slots it filled itself, so no barrier is
//    needed. Each warp loads the (dst, src, cf) of 32 pairs at a time, one
//    a lane, a chunk ahead, and shuffles them out.
// 3. L2 reuse. blockIdx.x (the item) runs fastest, so the blocks resident
//    at one time share one column slice of rows (8 MB at [4096, 512] f32),
//    which stays in L2 while every destination that reads it runs.
// 4. Stores. out is written once with streaming stores (st.global.cs) of
//    16 bytes, so it does not evict rows from L2. Where m % 4 != 0 or a
//    pointer is not aligned, the same walk loads and stores element by
//    element (`vec` = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVW = 4;                    // columns a thread
constexpr int kMC = kThreads * kVW;       // columns a block
constexpr int kS = 16;                    // ring slots: kS - 1 pairs in flight
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

// the (dst, src, cf) of pair s + 32 j + lane, zeros past e
__device__ __forceinline__ void load_meta(const int* __restrict__ dst, const int* __restrict__ src,
                                          const float* __restrict__ cf, int s, int e, int j,
                                          int lane, int& d, int& r, float& c) {
  const int p = s + 32 * j + lane;
  d = 0;
  r = 0;
  c = 0.f;
  if (p < e) {
    d = __ldg(dst + p);
    r = __ldg(src + p);
    c = __ldg(cf + p);
  }
}

// Starts the copy of source row `r`'s columns [col, col + 4) into `slot`
// and commits one group (an empty one when the thread has no columns or
// there is no pair), so that group q is always pair q's.
template <typename T, bool kVec>
__device__ __forceinline__ void stage(float4* slot, const T* __restrict__ rows, int m, int col,
                                      int r, bool copy) {
  if (copy) {
    const T* g = rows + size_t(r) * m + col;
    if constexpr (kVec) {
      cp_async(slot, g, kVW * sizeof(T));
    } else {
      float v[kVW];
#pragma unroll
      for (int i = 0; i < kVW; ++i) v[i] = col + i < m ? to_f(g[i]) : 0.f;
      *slot = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (kVec) cp_async_commit();
}

template <typename T, bool kVec>
__device__ __forceinline__ void unstage(const float4* slot, float* v) {
  if constexpr (kVec && sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(slot);
    v[0] = bf16_lo(u.x);
    v[1] = bf16_hi(u.x);
    v[2] = bf16_lo(u.y);
    v[3] = bf16_hi(u.y);
  } else {
    const float4 f = *slot;
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ out, int m, int col, int r,
                                          float* acc) {
  float* o = out + size_t(r) * m + col;
  if constexpr (kVec) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
#pragma unroll
    for (int i = 0; i < kVW; ++i)
      if (col + i < m) __stcs(o + i, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kVW; ++i) acc[i] = 0.f;
}

// One block: work item blockIdx.x (rows [r0, r1), pairs [s, e)), columns
// [blockIdx.y * kMC, + kMC). Threads past m take part in the warp's
// shuffles and copy and store nothing.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const int4* __restrict__ items, const int* __restrict__ dst,
                    const int* __restrict__ src, const float* __restrict__ cf,
                    const T* __restrict__ rows, float* __restrict__ out, int m) {
  __shared__ __align__(16) float4 ring[kS][kThreads];
  const int4 it = items[blockIdx.x];
  const int r0 = it.x, r1 = it.y, s = it.z, e = it.w;
  if (r0 >= r1) return;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.y * kMC + threadIdx.x * kVW;
  const bool live = col < m;
  const int n = e - s;
  float4* mine = &ring[0][threadIdx.x];

  // chunk A holds pairs [32 j, 32 j + 32) of the item, chunk B the next 32
  int ad, as, bd, bs;
  float ac, bc;
  load_meta(dst, src, cf, s, e, 0, lane, ad, as, ac);
  load_meta(dst, src, cf, s, e, 1, lane, bd, bs, bc);
#pragma unroll
  for (int q = 0; q < kS - 1; ++q) {
    const int r = __shfl_sync(kFull, as, q);
    stage<T, kVec>(mine + q * kThreads, rows, m, col, r, live && q < n);
  }

  float acc[kVW] = {0.f, 0.f, 0.f, 0.f};
  int cur = r0;
  for (int q = 0; q < n; ++q) {
    const int qi = q & 31;
    if (qi == 0 && q > 0) {
      ad = bd;
      as = bs;
      ac = bc;
      load_meta(dst, src, cf, s, e, (q >> 5) + 1, lane, bd, bs, bc);
    }
    const int d = __shfl_sync(kFull, ad, qi);
    const float c = __shfl_sync(kFull, ac, qi);
    // groups 0..q (pair q's copy among them) have landed: kS - 1 + q were committed
    if constexpr (kVec) cp_async_wait<kS - 2>();
    float v[kVW];
    unstage<T, kVec>(mine + (q % kS) * kThreads, v);
    // pair q + kS - 1 goes into slot (q - 1) % kS, whose values the adds of
    // pair q - 1 have consumed
    const int qa = qi + kS - 1;
    int r;
    if (qa < 32)
      r = __shfl_sync(kFull, as, qa);
    else
      r = __shfl_sync(kFull, bs, qa - 32);
    stage<T, kVec>(mine + ((q + kS - 1) % kS) * kThreads, rows, m, col, r,
                   live && q + kS - 1 < n);
    while (cur < d) {
      if (live) store_row<kVec>(out, m, col, cur, acc);
      ++cur;
    }
#pragma unroll
    for (int i = 0; i < kVW; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(c, v[i]));
  }
  for (; cur < r1; ++cur)
    if (live) store_row<kVec>(out, m, col, cur, acc);
  if constexpr (kVec) cp_async_wait<0>();
}

// ------------------------------------------------------------- work list

constexpr int kListThreads = 1024;

// row_start[r] = the first sorted pair whose destination is >= r, r = 0..n_out
__global__ void row_starts_kernel(const int* __restrict__ dst, int n_pairs, int n_out,
                                  int* __restrict__ row_start) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r > n_out) return;
  int lo = 0, hi = n_pairs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(dst + mid) < r)
      lo = mid + 1;
    else
      hi = mid;
  }
  row_start[r] = lo;
}

__device__ __forceinline__ bool is_hot(const int* rs, int r, int t) {
  return rs[r + 1] - rs[r] > t;
}

// a new item starts at row r: every rb-th row, at a hot row, and where the
// pairs before r cross a multiple of t (so after every hot row)
__device__ __forceinline__ bool is_cut(const int* rs, int r, int t, int rb) {
  return r % rb == 0 || is_hot(rs, r, t) || rs[r] / t != rs[r - 1] / t;
}

// exclusive block scan of 64-bit counts; `*total` gets the block's sum
__device__ long long block_excl_scan(long long v, long long* ws, long long* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    long long z = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    ws[lane] = z;
  }
  __syncthreads();
  *total = ws[nw - 1];
  return (w > 0 ? ws[w - 1] : 0) + x - v;
}

// An item starting at row r counts as (hot << 32) | cold: 1 << 32 for a
// hot row, 1 for the first row of a cold item, 0 inside an item.
__device__ __forceinline__ long long item_count(const int* rs, int r, int n_out, int t, int rb) {
  if (r >= n_out || !is_cut(rs, r, t, rb)) return 0;
  return is_hot(rs, r, t) ? (1LL << 32) : 1LL;
}

// A block a tile of kListThreads rows: the tile's item counts.
__global__ void __launch_bounds__(kListThreads)
list_count_kernel(const int* __restrict__ rs, int n_out, int t, int rb,
                  long long* __restrict__ tile_counts) {
  __shared__ long long ws[32];
  const int r = blockIdx.x * kListThreads + threadIdx.x;
  long long total;
  block_excl_scan(item_count(rs, r, n_out, t, rb), ws, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// A block a tile: the items that start in it, at their places in the list
// (hot items first, then cold ones, each in row order: the tiles before
// this one and the rows before r in it decide the place), and the empty
// tail from the last tile's block.
__global__ void __launch_bounds__(kListThreads)
list_write_kernel(const int* __restrict__ rs, int n_out, int t, int rb,
                  const long long* __restrict__ tile_counts, int n_items,
                  int4* __restrict__ items) {
  __shared__ long long ws[32];
  __shared__ long long base_s, total_s;
  if (threadIdx.x < 32) {
    long long before = 0, total = 0;
    for (int i = threadIdx.x; i < int(gridDim.x); i += 32) {
      const long long c = tile_counts[i];
      total += c;
      if (i < int(blockIdx.x)) before += c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(kFull, before, o);
      total += __shfl_xor_sync(kFull, total, o);
    }
    if (threadIdx.x == 0) {
      base_s = before;
      total_s = total;
    }
  }
  const int r = blockIdx.x * kListThreads + threadIdx.x;
  const long long mine = item_count(rs, r, n_out, t, rb);
  long long tile_total;
  const long long in_tile = block_excl_scan(mine, ws, &tile_total);  // syncs: base_s is set
  const long long pos = base_s + in_tile;
  const long long total = total_s;
  if (mine) {
    int r1 = r + 1;
    while (r1 < n_out && !is_cut(rs, r1, t, rb)) ++r1;
    const int slot = (mine >> 32) ? int(pos >> 32) : int(total >> 32) + int(pos & 0xFFFFFFFFLL);
    items[slot] = make_int4(r, r1, rs[r], rs[r1]);
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int used = int(total >> 32) + int(total & 0xFFFFFFFFLL);
    for (int i = used + threadIdx.x; i < n_items; i += kListThreads)
      items[i] = make_int4(n_out, n_out, rs[n_out], rs[n_out]);
  }
}

template <typename T>
int launch(const void* items, const void* dst, const void* src, const void* cf,
           const void* rows, void* out, int n_items, int m, int vec, cudaStream_t stream) {
  const dim3 grid(n_items, (m + kMC - 1) / kMC);
  const int4* it = static_cast<const int4*>(items);
  const int* d = static_cast<const int*>(dst);
  const int* s = static_cast<const int*>(src);
  const float* c = static_cast<const float*>(cf);
  const T* r = static_cast<const T*>(rows);
  float* o = static_cast<float*>(out);
  if (vec)
    scatter_rows_kernel<T, true><<<grid, kThreads, 0, stream>>>(it, d, s, c, r, o, m);
  else
    scatter_rows_kernel<T, false><<<grid, kThreads, 0, stream>>>(it, d, s, c, r, o, m);
  return int(cudaGetLastError());
}

}  // namespace

// The work list of `n_pairs` sorted destinations `dst` (sentinels n_out
// last) into `items` int32 [n_items, 4], n_items from ops/sparse_grad.py
// `work_list_bound`, t and rb its `_T` and `_RB`; `scratch` holds at least
// (n_out + 2) / 2 + ceil(n_out / kListThreads) 64-bit words (the n_out + 1
// int32 row starts, then the tiles' counts).
extern "C" int scatter_work_list(const void* dst, int n_pairs, int n_out, int t, int rb,
                                 void* scratch, void* items, int n_items, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* rs = static_cast<int*>(scratch);
  long long* tile_counts = static_cast<long long*>(scratch) + (n_out + 2) / 2;
  const int n_tiles = (n_out + kListThreads - 1) / kListThreads;
  row_starts_kernel<<<(n_out + 1 + 255) / 256, 256, 0, st>>>(static_cast<const int*>(dst),
                                                             n_pairs, n_out, rs);
  list_count_kernel<<<n_tiles, kListThreads, 0, st>>>(rs, n_out, t, rb, tile_counts);
  list_write_kernel<<<n_tiles, kListThreads, 0, st>>>(rs, n_out, t, rb, tile_counts, n_items,
                                                      static_cast<int4*>(items));
  return int(cudaGetLastError());
}

// `items`: int32 [n_items, 4] (r0, r1, s, e), from `scatter_work_list`;
// `vec`: m % 4 == 0 and rows, out 16-byte aligned.
extern "C" int scatter_rows_launch(const void* items, const void* dst, const void* src,
                                   const void* cf, const void* rows, void* out, int n_items,
                                   int m, int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(items, dst, src, cf, rows, out, n_items, m, vec, st);
  return launch<float>(items, dst, src, cf, rows, out, n_items, m, vec, st);
}

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
//   pass 2, one block per row: merges the n_tiles * k candidates, staged in
//     shared memory. The k-th best tile head is a lower bound of the k-th
//     best candidate, so only candidates at or above it are ranked (by
//     counting the candidates that beat them, one warp per candidate). The
//     k winners are emitted in ascending index order. When a row's
//     candidates exceed shared memory (wide dictionaries: 1024 tiles of 32
//     at 2^17), a first merge level takes groups of tiles, one block each,
//     and writes each group's best k in rank order, the format of a tile's
//     candidates; the second level merges those.
// Selection key: the f32 bit pattern of the relu'd value, with every NaN
// mapped to 0x7F800001 (just above +inf) and every value <= 0 (-0.0,
// negatives, -inf) to 0, as `_select_keys` does. Candidates are ordered by
// (key desc, index asc) through one int64 composite (key << 32 | 2^31-1-idx),
// so ties go to the lowest index. Key 0 never enters; a NaN takes a slot
// and is dropped at emit (its value is not > 0).
//
// Bound. At the serve shape (x [8, 4608] bf16, W_enc [4608, 16384] bf16)
// the function reads W_enc once: 151 MB, 45 us at 3.35 TB/s, against 1.2
// GFLOP (1.2 us at the bf16 tensor-core peak), so it is bound by bytes.
// Pass 1 streams W with 16-byte loads per thread and keeps the x rows in
// shared memory; the multiply runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPB = 8;     // rows per block in pass 1
constexpr int kCW = 128;       // dictionary columns per tile
constexpr int kSplit = 16;     // contraction splits in pass 1
constexpr int kVec = 8;        // columns per thread in pass 1
constexpr int kSent = 0x7F800001;
constexpr int kInfBits = 0x7F800000;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

__device__ __forceinline__ long long composite(int key, int col) {
  return key > 0 ? ((long long)key << 32) | (long long)(0x7FFFFFFF - col) : 0LL;
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
      const float hc = to_f(from_f<T>(h + b[gcol]));
      const int key = isnan(hc) ? kSent : (hc > 0.f ? __float_as_int(hc) : 0);
      comp = composite(key, gcol);
    }
    keys[o] = comp;
  }
  __syncthreads();

  // warp w ranks row w of the tile: rank = number of candidates that beat it
  const int w = tid >> 5, lane = tid & 31;
  const int row = row0 + w;
  if (row >= B) return;
  constexpr int PER_LANE = kCW / 32;
  long long mine[PER_LANE];
  int rank[PER_LANE];
  int npos = 0;
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u) {
    mine[u] = keys[w * kCW + lane + 32 * u];
    rank[u] = 0;
    npos += mine[u] > 0;
  }
  for (int c = 0; c < kCW; ++c) {
    const long long o = keys[w * kCW + c];
#pragma unroll
    for (int u = 0; u < PER_LANE; ++u) rank[u] += o > mine[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) npos += __shfl_xor_sync(0xffffffffu, npos, o);
  long long* out = cand + (size_t(row) * n_tiles + tile) * k;
#pragma unroll
  for (int u = 0; u < PER_LANE; ++u)
    if (mine[u] > 0 && rank[u] < k) out[rank[u]] = mine[u];
  for (int s = min(npos, k) + lane; s < k; s += 32) out[s] = 0;
}

// Block (row, g) merges tiles [g * group, g * group + group) of a row's
// row_tiles candidate lists; with `out`, it writes the best k in rank order
// to out[row, g, :] instead of emitting (vals, idx).
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const long long* __restrict__ cand,  // [B, row_tiles, k]
                  T* __restrict__ vals,                // [B, k]
                  int* __restrict__ idx,               // [B, k]
                  long long* __restrict__ out,         // [B, n_groups, k] or null
                  int row_tiles, int group, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x, g = blockIdx.y;
  const int n_tiles = min(group, row_tiles - g * group);
  long long* cs = reinterpret_cast<long long*>(smem);  // [n_tiles * k]
  const int N = n_tiles * k;
  long long* sel = cs + N;                              // [k]
  __shared__ long long theta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* base = cand + (size_t(row) * row_tiles + size_t(g) * group) * k;
  for (int i = tid; i < N; i += kThreads) cs[i] = base[i];
  for (int i = tid; i < k; i += kThreads) sel[i] = 0;
  if (tid == 0) theta = 0;
  __syncthreads();

  // k-th best tile head: at least k candidates are >= it
  if (n_tiles >= k) {
    for (int t = tid; t < n_tiles; t += kThreads) {
      const long long h = cs[t * k];
      int cnt = 0;
      for (int u = 0; u < n_tiles; ++u) cnt += cs[u * k] > h;
      if (cnt == k - 1) theta = h;
    }
  }
  __syncthreads();
  const long long th = theta;

  for (int e = warp; e < N; e += kThreads / 32) {
    const long long c = cs[e];
    if (c == 0 || c < th) continue;
    int cnt = 0;
    for (int i = lane; i < N; i += 32) cnt += cs[i] > c;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lane == 0 && cnt < k) sel[cnt] = c;
  }
  __syncthreads();
  if (out != nullptr) {
    for (int i = tid; i < k; i += kThreads) out[(size_t(row) * gridDim.y + g) * k + i] = sel[i];
    return;
  }

  // emit the winners with a positive value, lowest index first
  int n_emit = 0;
  for (int s = 0; s < k; ++s) {
    const int key = int(sel[s] >> 32);
    n_emit += key > 0 && key <= kInfBits;
  }
  for (int s = tid; s < k; s += kThreads) {
    const long long c = sel[s];
    const int key = int(c >> 32);
    if (key > 0 && key <= kInfBits) {
      const int id = 0x7FFFFFFF - int(c & 0xFFFFFFFFLL);
      int pos = 0;
      for (int u = 0; u < k; ++u) {
        const long long c2 = sel[u];
        const int key2 = int(c2 >> 32);
        const int id2 = 0x7FFFFFFF - int(c2 & 0xFFFFFFFFLL);
        pos += key2 > 0 && key2 <= kInfBits && id2 < id;
      }
      vals[size_t(row) * k + pos] = from_f<T>(__int_as_float(key));
      idx[size_t(row) * k + pos] = id;
    }
    if (s >= n_emit) {
      vals[size_t(row) * k + s] = from_f<T>(0.f);
      idx[size_t(row) * k + s] = 0;
    }
  }
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
  // group: the tiles whose candidates one merge block stages (n_tiles when
  // they all fit, else the wrapper's cand2 [B, n_groups, k] takes a level)
  const int n_groups = (n_tiles + group - 1) / group;
  const int widest = n_groups > 1 ? (group > n_groups ? group : n_groups) : n_tiles;
  const size_t smem2 = (size_t(widest) * k + k) * sizeof(long long);
  auto k2 = topk_merge_kernel<T>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem2));
  if (err != cudaSuccess) return int(err);
  const long long* c = static_cast<const long long*>(cand);
  int row_tiles = n_tiles;
  if (n_groups > 1) {
    k2<<<dim3(B, n_groups), kThreads, smem2, stream>>>(
        c, nullptr, nullptr, static_cast<long long*>(cand2), n_tiles, group, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    c = static_cast<const long long*>(cand2);
    row_tiles = n_groups;
  }
  k2<<<dim3(B, 1), kThreads, smem2, stream>>>(c, static_cast<T*>(vals), static_cast<int*>(idx),
                                              nullptr, row_tiles, row_tiles, k);
  return int(cudaGetLastError());
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

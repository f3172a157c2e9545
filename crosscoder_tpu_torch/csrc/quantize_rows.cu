// Block-scaled symmetric int8 quantization of rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crosscoder_tpu/ops/quant.py
// `_quantize_rows_kernel` (reached through `quantize_rows`). Function kept
// from it, per row r and block b of `block` contiguous elements:
//
//   amax     = max |x[r, b*block : (b+1)*block]|     (NaN if any is NaN)
//   scale    = amax * fl(1/127)                      (one rounding)
//   safe     = scale > 0 ? scale : 1
//   q[r, j]  = clip(rint(x[r, j] / safe), -127, 127) (round half to even)
//
// with q int8 [R, W] and scales f32 [R, W / block]. A quotient that is NaN
// (a NaN element, or inf / inf) stores 0, as the JAX package's float-to-
// int8 conversion does. The scale is the product with the f32 reciprocal
// of 127, which is what the JAX package computes wherever it runs compiled
// (XLA turns the division by the constant into that product: the jitted
// `quantize_blocks`, the buffer's quantize jits and the Pallas kernel);
// the element quotient is a true division (`__fdiv_rn`) and the rounding
// `rintf`, so the result is bitwise the plain version's (`quantize_blocks`
// in ops/quant.py); build without fast math.
// The TPU kernel's 32-row and full-tile gates (`rows_supported`) do not
// apply: any row count is taken.
//
// Bound. The function reads x once and writes q and the scales once:
// 3 bytes an element in bf16 plus 4 bytes a block (57 MB for a Gemma-2-2B
// harvest chunk of 4 x 1024 x 2 rows of 2304, 0.017 ms at 3.35 TB/s; 453
// MB for the int8 encoder's W [4608, 32768], 0.135 ms). |x| is folded as
// bit patterns (a NaN pattern is above +inf, two bf16 a word), so the
// work an element is one division and a few integer operations.
//
// Two routes, picked by the wrapper from the input's strides:
//
// Row route, contiguous rows (quantize_rows_kernel). The rows are one
// flat run of units (row, block) of `block` elements. A unit's chunks of
// 8 elements (one 16-byte load in bf16, two in f32) spread over a group of
// L lanes (L = 32, or the largest power of two up to the unit's chunk
// count), each lane holding up to M of them; a lane keeps kMax 16-byte
// loads in registers, so a warp loads several units before the first
// reduction, reduces each unit's max over its group with shuffles, and
// quantizes from the registers: one pass, one read. A grid sized to the
// SMs walks the units. Blocks past the registers (bf16 1024 elements,
// f32 512) take a second sweep that reloads the block.
//
// Column route, a transposed view (quantize_cols_kernel): x [R, d] with
// x[r, j] at x + j * ld + r, as `W2.t()` is. It quantizes the underlying
// [d, ld] source along its first axis where it lies and writes q [R, d]
// and the scales [R, d / block] contiguous, as the row route would for
// `x.contiguous()`, with no copy. A thread block takes a tile of 128
// bytes of source columns (64 bf16 or 32 f32: as many rows r of q) by one
// quantization block of source rows, 256 rows at a time: 16-byte loads
// along the source rows (4 full 128-byte lines a warp instruction), a
// column max over the tile's rows (shuffles, then shared memory), then
// each thread packs the int8 of 4 consecutive rows of a column into a word
// in shared memory, and the block writes each column's `block` int8 as one
// contiguous run of q.
// Blocks past 256 elements fold the max over all their 256-row stretches
// first, then reload each stretch to quantize it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInf = 0x7f800000u;
constexpr unsigned kNaN = 0x7fc00000u;

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of consecutive elements as bit patterns: 8 bf16 or 4 f32.
template <typename T> struct Raw;

template <> struct Raw<uint16_t> {
  static constexpr int kN = 8;                 // elements
  static constexpr int kMax = 4;               // row route: 16-byte loads a lane holds (64 bytes)
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const uint16_t* p, bool vec) {
    if (vec) {
      u = ldg16(p);
    } else {
      u.x = p[0] | unsigned(p[1]) << 16;
      u.y = p[2] | unsigned(p[3]) << 16;
      u.z = p[4] | unsigned(p[5]) << 16;
      u.w = p[6] | unsigned(p[7]) << 16;
    }
  }
  // element j (scalar loads past n are zero)
  __device__ __forceinline__ void load_n(const uint16_t* p, long long stride, int n) {
    unsigned s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = j < n ? unsigned(p[j * stride]) : 0u;
    u = make_uint4(s[0] | s[1] << 16, s[2] | s[3] << 16, s[4] | s[5] << 16, s[6] | s[7] << 16);
  }
  __device__ __forceinline__ unsigned word(int i) const {
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  }
  // the max |x| pattern of the 16 bytes, as an f32 pattern
  __device__ __forceinline__ unsigned amax() const {
    const unsigned m = __vmaxu2(__vmaxu2(u.x & 0x7FFF7FFFu, u.y & 0x7FFF7FFFu),
                                __vmaxu2(u.z & 0x7FFF7FFFu, u.w & 0x7FFF7FFFu));
    return max(m & 0xFFFFu, m >> 16) << 16;
  }
  __device__ __forceinline__ float value(int j) const {
    const unsigned w = word(j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xFFFF0000u) : (w << 16));
  }
  // fold |x| patterns into m, two columns a word
  __device__ __forceinline__ void fold_abs(unsigned (&m)[4]) const {
    m[0] = __vmaxu2(m[0], u.x & 0x7FFF7FFFu);
    m[1] = __vmaxu2(m[1], u.y & 0x7FFF7FFFu);
    m[2] = __vmaxu2(m[2], u.z & 0x7FFF7FFFu);
    m[3] = __vmaxu2(m[3], u.w & 0x7FFF7FFFu);
  }
  // the folded maxima as one f32 pattern a column
  static __device__ __forceinline__ void unfold(const unsigned (&m)[4], unsigned (&out)[kN]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = m[i] << 16;
      out[2 * i + 1] = m[i] & 0xFFFF0000u;
    }
  }
};

template <> struct Raw<float> {
  static constexpr int kN = 4;
  static constexpr int kMax = 4;
  uint4 u;
  __device__ __forceinline__ void zero() { u = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const float* p, bool vec) {
    if (vec) {
      u = ldg16(p);
    } else {
      u = make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]), __float_as_uint(p[2]),
                     __float_as_uint(p[3]));
    }
  }
  __device__ __forceinline__ void load_n(const float* p, long long stride, int n) {
    unsigned s[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = j < n ? __float_as_uint(p[j * stride]) : 0u;
    u = make_uint4(s[0], s[1], s[2], s[3]);
  }
  __device__ __forceinline__ unsigned word(int i) const {
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  }
  __device__ __forceinline__ unsigned amax() const {
    return max(max(u.x & 0x7FFFFFFFu, u.y & 0x7FFFFFFFu),
               max(u.z & 0x7FFFFFFFu, u.w & 0x7FFFFFFFu));
  }
  __device__ __forceinline__ float value(int j) const { return __uint_as_float(word(j)); }
  __device__ __forceinline__ void fold_abs(unsigned (&m)[4]) const {
    m[0] = max(m[0], u.x & 0x7FFFFFFFu);
    m[1] = max(m[1], u.y & 0x7FFFFFFFu);
    m[2] = max(m[2], u.z & 0x7FFFFFFFu);
    m[3] = max(m[3], u.w & 0x7FFFFFFFu);
  }
  static __device__ __forceinline__ void unfold(const unsigned (&m)[4], unsigned (&out)[kN]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = m[i];
  }
};

// A chunk of 8 consecutive elements of a row: one Raw in bf16, two in f32.
template <typename T> struct Chunk {
  static constexpr int kR = 8 / Raw<T>::kN;
  Raw<T> r[kR];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kR; ++i) r[i].zero();
  }
  __device__ __forceinline__ void load(const T* p, bool vec) {
#pragma unroll
    for (int i = 0; i < kR; ++i) r[i].load(p + i * Raw<T>::kN, vec);
  }
  __device__ __forceinline__ unsigned amax() const {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < kR; ++i) m = max(m, r[i].amax());
    return m;
  }
  __device__ __forceinline__ float value(int j) const {
    return r[j / Raw<T>::kN].value(j % Raw<T>::kN);
  }
};

// x / safe (a true division), rounded half to even, clipped to [-127,
// 127], NaN to 0, as one int8 in the low byte
__device__ __forceinline__ unsigned quantize_one(float x, float safe) {
  float q = __fdiv_rn(x, safe);
  if (q != q) q = 0.f;
  return unsigned(min(max(__float2int_rn(q), -127), 127)) & 0xFFu;
}

// the scale of a block from its max |x| pattern; `safe` is the divisor
__device__ __forceinline__ float scale_of(unsigned amax_bits, float& safe) {
  const float amax = __uint_as_float(amax_bits > kInf ? kNaN : amax_bits);
  const float scale = __fmul_rn(amax, __frcp_rn(127.f));
  safe = scale > 0.f ? scale : 1.f;
  return scale;
}

template <typename T>
__device__ __forceinline__ uint2 quantize_chunk(const Chunk<T>& ch, float safe) {
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo |= quantize_one(ch.value(j), safe) << (8 * j);
    hi |= quantize_one(ch.value(j + 4), safe) << (8 * j);
  }
  return make_uint2(lo, hi);
}

// ---- row route

// M: chunks a lane holds of one unit (a power of two, at least the unit's
// need m); 0: blocks past the registers, reloaded for a second sweep.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                     long long n_units, int block, int vec) {
  const int lane = threadIdx.x & 31;
  const int c = block >> 3;                                  // chunks a unit
  const int L = c >= 32 ? 32 : 1 << (31 - __clz(c));         // lanes a unit
  const int m = (c + L - 1) / L;                             // chunks a lane holds of a unit
  const int G = 32 / L;                                      // units side by side in a warp
  const int g = lane / L, sub = lane % L;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  if constexpr (M == 0) {
    for (long long unit = warp0; unit < n_units; unit += n_warps) {
      const T* xp = x + unit * block;
      unsigned a = 0;
      for (int cc = lane; cc < c; cc += 32) {
        Chunk<T> ch;
        ch.load(xp + cc * 8, vec);
        a = max(a, ch.amax());
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = max(a, __shfl_xor_sync(kFull, a, o));
      float safe;
      const float scale = scale_of(a, safe);
      for (int cc = lane; cc < c; cc += 32) {
        Chunk<T> ch;
        ch.load(xp + cc * 8, vec);
        *reinterpret_cast<uint2*>(q + unit * block + cc * 8) = quantize_chunk(ch, safe);
      }
      if (lane == 0) scales[unit] = scale;
    }
  } else {
    constexpr int kPer = Raw<T>::kMax / Chunk<T>::kR / M;    // unit rounds a step holds
    static_assert(kPer >= 1, "M past the registers");
    const long long step = (long long)G * kPer;
    for (long long u0 = warp0 * step; u0 < n_units; u0 += n_warps * step) {
      Chunk<T> ch[kPer][M];
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const long long unit = u0 + p * G + g;
#pragma unroll
        for (int t = 0; t < M; ++t) {
          const int cc = sub + L * t;
          if (unit < n_units && t < m && cc < c)
            ch[p][t].load(x + unit * block + cc * 8, vec);
          else
            ch[p][t].zero();
        }
      }
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const long long unit = u0 + p * G + g;
        unsigned a = 0;
#pragma unroll
        for (int t = 0; t < M; ++t) a = max(a, ch[p][t].amax());
        for (int o = L >> 1; o > 0; o >>= 1) a = max(a, __shfl_xor_sync(kFull, a, o));
        float safe;
        const float scale = scale_of(a, safe);
          if (unit < n_units) {
#pragma unroll
          for (int t = 0; t < M; ++t) {
            const int cc = sub + L * t;
            if (t < m && cc < c)
              *reinterpret_cast<uint2*>(q + unit * block + cc * 8) = quantize_chunk(ch[p][t], safe);
          }
          if (sub == 0) scales[unit] = scale;
        }
      }
    }
  }
}

template <typename T, int M>
int launch_rows(const T* x, int8_t* q, float* scales, long long n_units, int block, int vec,
                cudaStream_t stream) {
  static int grid_max = 0;                 // blocks that fit the card at once
  if (grid_max == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_rows_kernel<T, M>, kThreads,
                                                  0);
    grid_max = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int c = block / 8;
  const int L = c >= 32 ? 32 : 1 << (31 - __builtin_clz(c));
  constexpr int kPer = M == 0 ? 1 : Raw<T>::kMax / Chunk<T>::kR / (M == 0 ? 1 : M);
  const long long per_warp = M == 0 ? 1 : (long long)(32 / L) * kPer;
  const long long warps = (n_units + per_warp - 1) / per_warp;
  const long long want = (warps + kWarps - 1) / kWarps;
  const int grid = int(want < grid_max ? want : grid_max);
  quantize_rows_kernel<T, M><<<grid, kThreads, 0, stream>>>(x, q, scales, n_units, block, vec);
  return int(cudaGetLastError());
}

template <typename T>
int rows(const void* xv, void* qv, void* sv, long long n_units, int block, int vec,
         cudaStream_t stream) {
  if (n_units == 0) return 0;
  const T* x = static_cast<const T*>(xv);
  int8_t* q = static_cast<int8_t*>(qv);
  float* s = static_cast<float*>(sv);
  const int c = block / 8;
  const int L = c >= 32 ? 32 : 1 << (31 - __builtin_clz(c));
  const int m = (c + L - 1) / L;
  constexpr int kMaxM = Raw<T>::kMax / Chunk<T>::kR;        // chunks a lane in registers
  if (m <= 1) return launch_rows<T, 1>(x, q, s, n_units, block, vec, stream);
  if (m <= 2 && kMaxM >= 2) return launch_rows<T, (kMaxM >= 2 ? 2 : 1)>(x, q, s, n_units, block,
                                                                       vec, stream);
  if (m <= 4 && kMaxM >= 4) return launch_rows<T, (kMaxM >= 4 ? 4 : 1)>(x, q, s, n_units, block,
                                                                       vec, stream);
  if (m <= 8 && kMaxM >= 8) return launch_rows<T, (kMaxM >= 8 ? 8 : 1)>(x, q, s, n_units, block,
                                                                       vec, stream);
  return launch_rows<T, 0>(x, q, s, n_units, block, vec, stream);
}

// ---- column route

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_cols_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                     int R, int d, long long ld, int block, int vec) {
  constexpr int kV = Raw<T>::kN;               // columns a 16-byte load
  constexpr int kTC = 8 * kV;                  // columns a tile: 128 bytes of a source row
  __shared__ unsigned qt[kTC * 64];            // int8 of 256 rows a column, 4 to a word
  __shared__ unsigned red[kWarps][kTC];
  __shared__ float safe_s[kTC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7, rq = tid >> 3;       // load group (kV columns), row quad
  const int r0 = blockIdx.x * kTC;
  const int b = blockIdx.y;
  const int nb = d / block;
  const int nsub = (block + 255) / 256;
  const int col = r0 + cg * kV;                // this thread's first column
  const int ncol = min(kV, R - col);           // of which in range
  const bool full = vec && ncol == kV;
  Raw<T> v[2][4];                              // rows 4 rq + a + 128 i of a 256-row stretch

  auto load = [&](int s) {
    const int rows = min(256, block - s * 256);
    const T* src = x + (long long)(b * block + s * 256) * ld + col;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = 4 * rq + a + 128 * i;
        if (j < rows && ncol > 0) {
          if (full)
            v[i][a].load(src + j * ld, true);
          else
            v[i][a].load_n(src + j * ld, 1, ncol);
        } else {
          v[i][a].zero();
        }
      }
    }
  };

  // sweep 1: each column's max |x| pattern over the block's rows
  unsigned mw[4] = {0u, 0u, 0u, 0u};           // by 32-bit word of the loads (two bf16 columns)
  for (int s = 0; s < nsub; ++s) {
    load(s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int a = 0; a < 4; ++a) v[i][a].fold_abs(mw);
    }
  }
  unsigned mx[kV];
  Raw<T>::unfold(mw, mx);
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    mx[e] = max(mx[e], __shfl_xor_sync(kFull, mx[e], 8));
    mx[e] = max(mx[e], __shfl_xor_sync(kFull, mx[e], 16));
  }
  if (lane < 8) {
#pragma unroll
    for (int e = 0; e < kV; ++e) red[warp][cg * kV + e] = mx[e];
  }
  __syncthreads();
  if (tid < kTC) {
    unsigned a = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = max(a, red[w][tid]);
    float safe;
    const float scale = scale_of(a, safe);
    safe_s[tid] = safe;
    if (r0 + tid < R) scales[(long long)(r0 + tid) * nb + b] = scale;
  }
  __syncthreads();
  float safe[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) safe[e] = safe_s[cg * kV + e];

  // sweep 2: quantize each 256-row stretch, transpose it through shared
  // memory and write each column's run of int8
  for (int s = 0; s < nsub; ++s) {
    if (nsub > 1) load(s);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned w = 0;
#pragma unroll
        for (int a = 0; a < 4; ++a) w |= quantize_one(v[i][a].value(e), safe[e]) << (8 * a);
        qt[(cg * kV + e) * 64 + rq + 32 * i] = w;
      }
    }
    __syncthreads();
    const int words = min(256, block - s * 256) / 4;       // words a column
    int8_t* out = q + (long long)r0 * d + (long long)b * block + s * 256;
    for (int i = tid; i < kTC * words; i += kThreads) {
      const int c = i / words, w = i - c * words;
      if (r0 + c < R)
        *reinterpret_cast<unsigned*>(out + (long long)c * d + 4 * w) =
            qt[c * 64 + w];
    }
    __syncthreads();
  }
}

template <typename T>
int cols(const void* x, void* q, void* s, int R, int d, long long ld, int block, int vec,
         cudaStream_t stream) {
  if (R == 0 || d == 0) return 0;
  constexpr int kTC = 8 * Raw<T>::kN;
  const dim3 grid((R + kTC - 1) / kTC, d / block);
  quantize_cols_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(s), R, d, ld, block,
      vec);
  return int(cudaGetLastError());
}

}  // namespace

// Row route: x [n_units * block] contiguous; q alike, scales [n_units].
extern "C" int quantize_rows_launch(const void* x, void* q, void* scales, long long n_units,
                                    int block, int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rows<uint16_t>(x, q, scales, n_units, block, vec, st);
  return rows<float>(x, q, scales, n_units, block, vec, st);
}

// Column route: element (r, j) of the [R, d] view at x + j * ld + r; q [R,
// d] and scales [R, d / block] contiguous.
extern "C" int quantize_cols_launch(const void* x, void* q, void* scales, int R, int d,
                                    long long ld, int block, int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return cols<uint16_t>(x, q, scales, R, d, ld, block, vec, st);
  return cols<float>(x, q, scales, R, d, ld, block, vec, st);
}

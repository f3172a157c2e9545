// The encoder product tile shared by the fused encoder kernels on Hopper's
// tensor cores: fused_topk.cu (K2) and fused_batchtopk.cu (K4) in bf16,
// fused_topk_q.cu (K3) in int8. Its tensor maps, TMA copies, barriers and
// wgmma helpers also serve paged_attention.cu's bf16 kernel (K1).
//
// A block walks [128 rows x 128 columns] output tiles of x [B, nd] . W
// [nd, width], the row block fastest, so the blocks that run at once share
// a few column slices of W and W comes from device memory about once. The
// grid is persistent: one block an SM.
//
// A block is three warpgroups. Thread 0 of the first is the producer: it
// keeps a ring of kStages stages in shared memory filled with TMA loads
// (cp.async.bulk.tensor.2d, 128-byte swizzle), with a full and an empty
// mbarrier a stage (Ring, produce). The other two warpgroups are
// consumers, 64 rows each, with the sum in 64 registers a thread; after a
// tile, each hands its accumulators to the kernel's epilogue with the
// fragment's (row, column) map (frag_row, frag_col). Two main loops share
// the ring:
//
// run_tiles, bf16: a stage is an x box [128 rows x 64 contraction] and two
// W boxes [64 contraction x 64 columns] (a 128-byte swizzle span is 64
// bf16, so the 128 columns take two boxes), 32 KB; four wgmma.mma_async
// m64n128k16 a stage with both operands in shared memory, A K-major, B
// MN-major (W row-major is read through the instruction's transpose bit,
// never copied), fp32 sums.
//
// run_tiles_q, int8 block-scaled (K3): 8-bit wgmma has no transpose bit,
// so both operands are K-major: xq [B, nd] and wqT [width, nd], each a box
// [128 rows x 128 contraction bytes] a stage (32 KB), plus the stage's
// scale rows (xsT [nb, B] and ws [nb, width], f32, a box [nbs blocks x 128]
// each, unswizzled). Four wgmma.mma_async m64n128k32 .s32.s8.s8 a stage
// sum the int32 product of one quantization block exactly (|p| <= block *
// 127^2 < 2^31); the first k-step of a block restarts the sum (scale-d =
// 0), and after its last the warpgroup waits for its wgmmas and folds the
// block into an f32 accumulator as acc = acc + (p * xs[row]) * ws[col],
// each step rounded (__fmul_rn, __fadd_rn) in ascending block order, as
// the plain version does.
//
// TMA fills rows past B, columns past width and the contraction tail past
// nd with zeros, so those products add nothing; the epilogue still masks
// rows >= B and columns >= width out of what it emits or counts.
//
// On integer-valued bf16 operands every partial sum is an exact integer
// below 2^24, so the fp32 result equals the plain version's in any order.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_sync.cuh"

namespace etile {

constexpr int kBM = 128;                         // tile rows (2 consumer warpgroups x 64)
constexpr int kBN = 128;                         // tile columns
constexpr int kBK = 64;                          // contraction a stage (one 128-byte swizzle span)
constexpr int kWG = 128;                         // threads a warpgroup
constexpr int kThreads = 3 * kWG;                // producer warpgroup + 2 consumer warpgroups
constexpr int kXBytes = kBM * kBK * 2;           // x box, 16 KB
constexpr int kWHalfBytes = kBK * 64 * 2;        // one W box of 64 columns, 8 KB
constexpr int kStageBytes = kXBytes + 2 * kWHalfBytes;
constexpr int kAlign = 1024;                     // the 128-byte swizzle atom: 8 rows x 128 B

// int8 (K3): contraction bytes a stage, k-step of the s8 wgmma, operand
// boxes, and the scale rows a stage can need (a block of 32 spans a
// quarter of a stage)
constexpr int kQBK = 128;                        // one 128-byte swizzle span
constexpr int kQK = 32;
constexpr int kQXBytes = kBM * kQBK;             // xq box, 16 KB
constexpr int kQOpBytes = kQXBytes + kBN * kQBK; // + wqT box, 16 KB
constexpr int kQScaleRows = 4;
constexpr int kQStageBytes = kQOpBytes + 2 * kQScaleRows * kBM * 4;   // 36 KB, kAlign-aligned

// Shared memory of a ring of kStages stages and its barriers.
__host__ __device__ constexpr size_t ring_bytes(int stages, int stage_bytes = kStageBytes) {
  return size_t(stages) * (stage_bytes + 16);
}

// Scale rows a stage of int8 contraction holds: every block of `qb` that
// a 128-byte span starting at a multiple of 128 can meet.
__host__ __device__ inline int q_scale_rows(int qb) {
  if (qb % kQBK == 0) return 1;
  if (kQBK % qb == 0) return kQBK / qb;
  return (kQBK + qb - 1) / qb + 1;
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps; cuTensorMapEncodeTiled is looked up at run time (no -lcuda)

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes above kMapError: cuTensorMapEncodeTiled's CUresult + kMapError.
constexpr int kMapError = 100000;

// A row-major tensor of `rank` (<= 5) dimensions, innermost first: dims[0]
// values of `type` contiguous, strides[i] bytes between steps of dimension
// i + 1, read in boxes box[0..rank); out-of-bounds elements read as zero
// (and a TMA store skips them).
inline int encode_map_nd(CUtensorMap* map, CUtensorMapDataType type, uint32_t rank,
                         CUtensorMapSwizzle swizzle, const void* base, const uint64_t* dims,
                         const uint64_t* strides, const uint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                            &found);
#endif
    if (e != cudaSuccess) return int(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return kMapError + 500;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], estr[5];
  for (uint32_t i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    estr[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), d, s, b, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + int(r);
}

// A row-major matrix [outer, inner] of `elem` bytes a value read in boxes
// [box_outer, box_inner]; out-of-bounds elements read as zero.
inline int encode_map_of(CUtensorMap* map, CUtensorMapDataType type, uint32_t elem,
                         CUtensorMapSwizzle swizzle, const void* base, uint64_t inner,
                         uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  const uint64_t dims[2] = {inner, outer};
  const uint64_t strides[1] = {inner * elem};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode_map_nd(map, type, 2, swizzle, base, dims, strides, box);
}

// A row-major bf16 matrix with the 128-byte swizzle.
inline int encode_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                      uint32_t box_inner, uint32_t box_outer) {
  return encode_map_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_128B, base,
                       inner, outer, box_inner, box_outer);
}

// The maps of x [B, nd] (boxes [128, 64]) and W [nd, width] (boxes [64, 64]).
inline int encode_operands(CUtensorMap* xm, CUtensorMap* wm, const void* x, const void* W, int B,
                           int nd, int width) {
  const int e = encode_map(xm, x, uint64_t(nd), uint64_t(B), kBK, kBM);
  return e != 0 ? e : encode_map(wm, W, uint64_t(width), uint64_t(nd), 64, kBK);
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

__host__ __device__ inline int n_tiles(int B, int width) {
  return ((B + kBM - 1) / kBM) * ((width + kBN - 1) / kBN);
}

// ---------------------------------------------------------------------------
// device: barriers, TMA, wgmma

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int inner,
                                         int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// The 4-D box at {c0, c1, c2, c3} (innermost first) into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The 4-D box at {c0, c1, c2, c3} out of shared memory, as one bulk group
// (elements out of bounds are not written). The writer threads fence their
// shared-memory writes to the async proxy and synchronize first.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Wait until every bulk group this thread committed has read its shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Shared-memory writes of this thread visible to the async proxy (TMA, wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier over one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + cw), "r"(kWG) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A K-major, B MN-major.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 32] . B[32 x 128] in int32, A and B int8 K-major
// (8-bit wgmma has no transpose bit).
__device__ __forceinline__ void wgmma_s8_128(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Accumulator i of thread t (0..127) of a consumer warpgroup sits at row
// frag_row(i, t) of the warpgroup's 64 and column frag_col(i, t) of the
// tile's 128; i and i + 1 (i even) are adjacent columns of one row.
__device__ __forceinline__ int frag_row(int i, int t) {
  return ((t >> 5) << 4) + ((t & 31) >> 2) + (((i >> 1) & 1) << 3);
}
__device__ __forceinline__ int frag_col(int i, int t) {
  return ((i >> 2) << 3) + ((t & 3) << 1) + (i & 1);
}

// The ring: kStages stages of kBytes each in shared memory, then a full
// and an empty mbarrier a stage (the full one completes on the stage's TMA
// bytes, the empty one on both consumer warpgroups' release).
template <int kStages, int kBytes>
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(unsigned char* r)
      : base(r),
        full(reinterpret_cast<uint64_t*>(r + size_t(kStages) * kBytes)),
        empty(full + kStages) {}

  __device__ __forceinline__ unsigned char* stage(int s) const { return base + size_t(s) * kBytes; }

  // run by every thread of the block
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 2);
      }
      sm90::mbar_init_fence();
    }
    __syncthreads();
  }
};

// A position in the ring, stepped alike by the producer and the consumers.
template <int kStages>
struct Cursor {
  int stage = 0;
  uint32_t phase = 0;

  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer (one thread): for each tile of this block, nk stages, each
// filled by load(stage, full barrier, kb, row0, c0) with tx_bytes of TMA
// loads once both consumers have released it.
template <int kStages, int kBytes, class Load>
__device__ __forceinline__ void produce(const Ring<kStages, kBytes>& ring, int n_rb, int total,
                                        int nk, uint32_t tx_bytes, Load load) {
  Cursor<kStages> cur;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int row0 = (t % n_rb) * kBM, c0 = (t / n_rb) * kBN;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&ring.empty[cur.stage], cur.phase ^ 1);
      mbar_expect_tx(&ring.full[cur.stage], tx_bytes);
      load(ring.stage(cur.stage), &ring.full[cur.stage], kb, row0, c0);
      cur.next();
    }
  }
}

// The bf16 tile loop, run by all kThreads threads of the block. `ring`:
// ring_bytes(kStages) bytes of shared memory, kAlign-aligned. After each
// tile, each consumer warpgroup calls epi(acc, row0, c0, cw, t): cw its
// index (0, 1; rows row0 + 64 cw ...), t its thread (0..127). The caller
// synchronizes the block afterwards if it needs to.
template <int kStages, class Epilogue>
__device__ __forceinline__ void run_tiles(const CUtensorMap* xm, const CUtensorMap* wm,
                                          unsigned char* ring_mem, int B, int nd, int width,
                                          Epilogue& epi) {
  const Ring<kStages, kStageBytes> ring(ring_mem);
  ring.init();

  const int tid = threadIdx.x;
  const int n_rb = (B + kBM - 1) / kBM;
  const int total = n_tiles(B, width);
  const int nk = (nd + kBK - 1) / kBK;
  const int wg = tid / kWG;

  if (wg == 0) {
    if (tid == 0)
      produce(ring, n_rb, total, nk, kStageBytes,
              [&](unsigned char* st, uint64_t* bar, int kb, int row0, int c0) {
                tma_load(st, xm, bar, kb * kBK, row0);
                tma_load(st + kXBytes, wm, bar, c0, kb * kBK);
                tma_load(st + kXBytes + kWHalfBytes, wm, bar, c0 + 64, kb * kBK);
              });
    __syncwarp();
    return;
  }

  const int cw = wg - 1, t = tid % kWG;
  Cursor<kStages> cur;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int row0 = (tile % n_rb) * kBM, c0 = (tile / n_rb) * kBN;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&ring.full[cur.stage], cur.phase);
      const uint32_t xa = smem_u32(ring.stage(cur.stage)) + cw * 64 * 128;
      const uint32_t wa = smem_u32(ring.stage(cur.stage) + kXBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        // A: 16 contraction columns are 32 bytes into each 128-byte row;
        // B: 16 contraction rows are 2 swizzle atoms of 8 rows x 128 B,
        // the second 64 columns a box (8 KB) further
        wgmma_128(acc, desc(xa + kk * 32, 16, 1024), desc(wa + kk * 2048, kWHalfBytes, 1024),
                  kb > 0 || kk > 0);
      wgmma_commit();
      if (kb > 0) {
        wgmma_wait<1>();
        if (t == 0) mbar_arrive(&ring.empty[prev]);
      }
      prev = cur.stage;
      cur.next();
    }
    wgmma_wait<0>();
    if (t == 0) mbar_arrive(&ring.empty[prev]);
    fence_acc(acc);
    epi(acc, row0, c0, cw, t);
  }
}

// Fold one quantization block's exact int32 product p into acc in the
// plain version's rounding: acc + (float(p) * xs[row]) * ws[col]. sx: the
// block's x scales of this warpgroup's 64 rows; sw: its W scales of the
// tile's 128 columns (both in shared memory).
__device__ __forceinline__ void fold_block(float (&acc)[64], const int (&p)[64], const float* sx,
                                           const float* sw, int t) {
  const float x0 = sx[frag_row(0, t)], x1 = sx[frag_row(2, t)];   // rows r and r + 8
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const float2 w = *reinterpret_cast<const float2*>(sw + frag_col(i, t));
    const float xr = ((i >> 1) & 1) ? x1 : x0;
    acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(__int2float_rn(p[i]), xr), w.x));
    acc[i + 1] = __fadd_rn(acc[i + 1], __fmul_rn(__fmul_rn(__int2float_rn(p[i + 1]), xr), w.y));
  }
}

// The int8 block-scaled tile loop (K3), run by all kThreads threads of the
// block. Maps: xm xq [B, nd] and wm wqT [width, nd] (int8, boxes [128 x
// 128 B], 128-byte swizzle), xsm xsT [nb, >= B] and wsm ws [nb, width]
// (f32, boxes [nbs x 128], no swizzle). qb: the quantization block, a
// multiple of 32 dividing nd; nbs = q_scale_rows(qb); kAligned: qb % 128
// == 0. `ring`: ring_bytes(kStages, kQStageBytes)
// bytes, kAlign-aligned. The epilogue as run_tiles'.
//
// ptxas serializes every wgmma of a kernel when it has to insert a wgmma
// fence of its own on a path it cannot prove uniform, so both consumer
// loops keep the accumulator's accesses (the block's wait and fold) on
// their straight path and an explicit fence before the wgmmas that follow
// a barrier wait or a fold:
//   kAligned (the blocks of 128 and 256 the trainer uses): run_tiles'
//     stage loop, a block being qb / 128 whole stages: per stage a fence,
//     the stage's four wgmmas, a commit, the previous stage released once
//     all groups but the newest are done; after the block's last stage, a
//     wait for all and the fold.
//   otherwise (blocks of 32, 64, 96, ... that start or end inside a
//     stage): a block's k-steps one by one, each wgmma after its own
//     fence; a consumed stage is released once the wgmmas of the stage
//     after it are committed, and every consumed stage at a block's end.
template <int kStages, bool kAligned, class Epilogue>
__device__ __forceinline__ void run_tiles_q(const CUtensorMap* xm, const CUtensorMap* wm,
                                            const CUtensorMap* xsm, const CUtensorMap* wsm,
                                            unsigned char* ring_mem, int B, int nd, int width,
                                            int qb, int nbs, Epilogue& epi) {
  const Ring<kStages, kQStageBytes> ring(ring_mem);
  ring.init();

  const int tid = threadIdx.x;
  const int n_rb = (B + kBM - 1) / kBM;
  const int total = n_tiles(B, width);
  const int nk = (nd + kQBK - 1) / kQBK;
  const int wg = tid / kWG;

  if (wg == 0) {
    if (tid == 0)
      produce(ring, n_rb, total, nk, uint32_t(kQOpBytes + 2 * nbs * kBM * 4),
              [&](unsigned char* st, uint64_t* bar, int kb, int row0, int c0) {
                const int q_lo = kb * kQBK / qb;   // the block of the stage's first byte
                tma_load(st, xm, bar, kb * kQBK, row0);
                tma_load(st + kQXBytes, wm, bar, kb * kQBK, c0);
                tma_load(st + kQOpBytes, xsm, bar, row0, q_lo);
                tma_load(st + kQOpBytes + kQScaleRows * kBM * 4, wsm, bar, c0, q_lo);
              });
    __syncwarp();
    return;
  }

  constexpr int kSteps = kQBK / kQK;  // k-steps a stage
  const int cw = wg - 1, t = tid % kWG;
  const int spb = qb / kQK;          // k-steps a block
  const int nb = nd / qb;
  Cursor<kStages> cur, rel;          // the stage in use; the oldest not yet released
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int row0 = (tile % n_rb) * kBM, c0 = (tile / n_rb) * kBN;
    float acc[64];
    int p[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc[i] = 0.f;
      p[i] = 0;
    }
    if constexpr (kAligned) {
      const int spst = qb / kQBK;    // stages a block
      int prev = -1;
      for (int q = 0; q < nb; ++q) {
        for (int j = 0; j < spst; ++j) {
          mbar_wait(&ring.full[cur.stage], cur.phase);
          const uint32_t xa = smem_u32(ring.stage(cur.stage)) + cw * 64 * kQBK;
          const uint32_t wa = smem_u32(ring.stage(cur.stage) + kQXBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk)
            // both operands: 32 contraction bytes into each 128-byte row,
            // 8-row swizzle atoms 1 KB apart
            wgmma_s8_128(p, desc(xa + kk * 32, 16, 1024), desc(wa + kk * 32, 16, 1024),
                         j > 0 || kk > 0);
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait<1>();
            if (t == 0) mbar_arrive(&ring.empty[prev]);
          }
          prev = cur.stage;
          cur.next();
        }
        wgmma_wait<0>();
        fence_acc(p);
        const float* sc = reinterpret_cast<const float*>(ring.stage(prev) + kQOpBytes);
        fold_block(acc, p, sc + cw * 64, sc + kQScaleRows * kBM, t);
        if (t == 0) mbar_arrive(&ring.empty[prev]);
        prev = -1;
      }
    } else {
      int kk = 0;                    // the next k-step in the current stage
      int kb = 0;                    // the current stage within the tile
      int pending = 0;               // consumed stages not yet released
      for (int q = 0; q < nb; ++q) {
        for (int i = 0; i < spb; ++i) {
          if (kk == 0) mbar_wait(&ring.full[cur.stage], cur.phase);
          const uint32_t st = smem_u32(ring.stage(cur.stage));
          wgmma_fence();
          wgmma_s8_128(p, desc(st + cw * 64 * kQBK + kk * 32, 16, 1024),
                       desc(st + kQXBytes + kk * 32, 16, 1024), i > 0);
          if (++kk == kSteps) {      // the stage is consumed
            cur.next();
            kk = 0;
            ++kb;
            ++pending;
            wgmma_commit();
            if (pending > 1) {       // the stage before this one is done
              wgmma_wait<1>();
              if (t == 0) mbar_arrive(&ring.empty[rel.stage]);
              rel.next();
              --pending;
            }
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(p);
        // the block ends in the current stage, or (kk == 0) in the one just consumed
        const int s_end = kk == 0 ? (cur.stage + kStages - 1) % kStages : cur.stage;
        const int qs = q - (kk == 0 ? kb - 1 : kb) * kQBK / qb;
        const float* sc = reinterpret_cast<const float*>(ring.stage(s_end) + kQOpBytes);
        fold_block(acc, p, sc + qs * kBM + cw * 64, sc + kQScaleRows * kBM + qs * kBM, t);
        for (; pending > 0; --pending) {   // every wgmma is done: release what was consumed
          if (t == 0) mbar_arrive(&ring.empty[rel.stage]);
          rel.next();
        }
      }
      if (kk != 0) {                 // a partial last stage (nd % 128 != 0)
        if (t == 0) mbar_arrive(&ring.empty[rel.stage]);
        rel.next();
        cur.next();
      }
    }
    fence_acc(acc);
    epi(acc, row0, c0, cw, t);
  }
}

// Launch a tile kernel kern(x map, W map, args...) on one block an SM (at
// most one a tile) with `smem` bytes of dynamic shared memory; returns a
// CUDA error code (or a tensor-map error above kMapError).
template <typename Kernel, typename... Args>
int launch(Kernel kern, size_t smem, const void* x, const void* W, int B, int nd, int width,
           cudaStream_t stream, Args... args) {
  CUtensorMap xm, wm;
  const int e = encode_operands(&xm, &wm, x, W, B, nd, width);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int total = n_tiles(B, width), sms = sm_count();
  kern<<<total < sms ? total : sms, kThreads, smem, stream>>>(xm, wm, args...);
  return int(cudaGetLastError());
}

}  // namespace etile

// Global-norm clip + Adam + learning rate, in place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax's chain
// crosscoder_tpu/train/state.py `make_optimizer` (clip_by_global_norm ->
// scale_by_adam -> scale_by_learning_rate), which XLA fuses into one pass
// a leaf inside the jitted train step (crosscoder_tpu/train/trainer.py
// `make_train_step`). Run eagerly, the same chain is some 36 elementwise
// passes over each leaf; this kernel is the one pass XLA makes.
//
// Function, per element of each leaf, with T the leaf's dtype (f32 or
// bf16, leaf by leaf: bf16 masters beside the f32 `log_theta` of a
// JumpReLU crosscoder in one launch) and every step rounded to T as
// PyTorch's eager ops round (`adam_update_plain` in ops/adam.py, the op
// sequence of the port's Optimizer):
//
//   norm     = norms[e / (n / n_tenants)]         (f32, on the card)
//   clip     = !(norm < max_norm)
//   g        = clip ? T(T(g / T(norm)) * max_norm) : g
//   m'       = T(T(g * c1) + T(m * b1))           c1 = f32(1 - b1)
//   v'       = T(T(T(g * g) * c2) + T(v * b2))    c2 = f32(1 - b2)
//   u        = T(T(m' / T(bc1)) / T(T(sqrt(T(v' / T(bc2)))) + eps))
//   p'       = T(p + T(T(step) * u))
//
// Every product, sum, quotient and root is IEEE round-to-nearest in f32
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: nothing contracts into an
// FMA), then rounded to T, so the result is bitwise the plain version's on
// the card given the same norm. The scalars are f32 as PyTorch makes them
// from Python floats; bc1, bc2 and step are rounded to T as the plain
// version's 0-d tensors are, each leaf to its own T. The norm is read on
// the card: no host sync.
//
// A fleet cohort (train/fleet.py) steps n_tenants crosscoders in one
// launch: each leaf is the tenants' leaves stacked on a leading axis, so
// element e of a leaf of n elements belongs to tenant e / (n / n_tenants)
// and is clipped by that tenant's own global norm; the bias corrections
// and the learning rate are the cohort's (its tenants step in lockstep).
// With n_tenants = 1 the kernel is the solo update, bitwise.
//
// Bound. Each element is read from p, g, m and v once and p', m' and v'
// are written once: 28 bytes an element in f32 (14 in bf16). Leg A's four
// leaves (W_enc, W_dec [2 * 2304 * 32768] each, b_enc, b_dec: 302,027,264
// values) move 8.456 GB, 2.52 ms at 3.35 TB/s; about 20 operations an
// element are far below the card's rate. So the design is a stream: one
// 16-byte load of each input a thread (4 f32 or 8 bf16 elements), 256
// threads a block, every leaf in one launch (a block finds its leaf from
// the leaves' first blocks, passed by value, and branches on the leaf's
// dtype tag, the same for the whole block), the tail of a leaf and
// unaligned leaves element by element. In place when the outputs are the
// inputs (the trainer's donated step); each element is read before it is
// written, by the same thread. A 16-byte chunk lies in one tenant when a
// tenant's share of the leaf is a multiple of the chunk (else the leaf
// goes element by element), so a thread finds its tenant with one
// division and reads one norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 8;

struct Leaf {
  const void* g;
  const void* p;
  const void* m;
  const void* v;
  void* po;
  void* mo;
  void* vo;
  long long n;
  long long per;           // elements a tenant: n / n_tenants
  long long first_block;   // blocks of earlier leaves
  int vec;                 // every pointer 16-byte aligned, chunks within a tenant
  int bf16;                // dtype tag: 1 bf16, 0 f32
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
};

struct Coef {
  float max_norm, c1, b1, c2, b2, eps, bc1, bc2, step;
};

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int kVec = 4;
  __device__ static float get(float x) { return x; }
  __device__ static float put(float x) { return x; }
  __device__ static float rt(float x) { return x; }
};

template <>
struct Elt<uint16_t> {   // bf16 bit patterns
  static constexpr int kVec = 8;
  __device__ static float get(uint16_t x) { return __uint_as_float(uint32_t(x) << 16); }
  __device__ static uint16_t put(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
  __device__ static float rt(float x) { return get(put(x)); }
};

template <typename T>
__device__ __forceinline__ void adam_one(float g, float p, float m, float v, bool clip,
                                         float norm, const Coef& c, float& po, float& mo,
                                         float& vo) {
  using E = Elt<T>;
  if (clip) g = E::rt(__fmul_rn(E::rt(__fdiv_rn(g, norm)), c.max_norm));
  mo = E::rt(__fadd_rn(E::rt(__fmul_rn(g, c.c1)), E::rt(__fmul_rn(m, c.b1))));
  vo = E::rt(__fadd_rn(E::rt(__fmul_rn(E::rt(__fmul_rn(g, g)), c.c2)),
                       E::rt(__fmul_rn(v, c.b2))));
  const float mh = E::rt(__fdiv_rn(mo, c.bc1));
  const float vh = E::rt(__fdiv_rn(vo, c.bc2));
  const float den = E::rt(__fadd_rn(E::rt(__fsqrt_rn(vh)), c.eps));
  const float u = E::rt(__fmul_rn(c.step, E::rt(__fdiv_rn(mh, den))));
  po = E::rt(__fadd_rn(p, u));
}

// One block's share of leaf L, whose elements are T; norms[t] is tenant
// t's global norm.
template <typename T>
__device__ __forceinline__ void adam_leaf(const Leaf& L, long long b,
                                          const float* __restrict__ norms, int n_tenants,
                                          Coef c) {
  using E = Elt<T>;
  constexpr int V = E::kVec;
  c.bc1 = E::rt(c.bc1);
  c.bc2 = E::rt(c.bc2);
  c.step = E::rt(c.step);
  const long long i0 = ((b - L.first_block) * kThreads + threadIdx.x) * V;
  if (i0 >= L.n) return;
  const float norm = norms[n_tenants > 1 ? int(i0 / L.per) : 0];
  const bool clip = !(norm < c.max_norm);
  const float normT = E::rt(norm);
  const T* g = static_cast<const T*>(L.g);
  const T* p = static_cast<const T*>(L.p);
  const T* m = static_cast<const T*>(L.m);
  const T* v = static_cast<const T*>(L.v);
  T* po = static_cast<T*>(L.po);
  T* mo = static_cast<T*>(L.mo);
  T* vo = static_cast<T*>(L.vo);
  if (L.vec && i0 + V <= L.n) {
    // one 16-byte load of each input; every load before any store
    union U { uint4 w; T e[V]; };
    U ug, up, um, uv, rp, rm, rv;
    ug.w = *reinterpret_cast<const uint4*>(g + i0);
    up.w = *reinterpret_cast<const uint4*>(p + i0);
    um.w = *reinterpret_cast<const uint4*>(m + i0);
    uv.w = *reinterpret_cast<const uint4*>(v + i0);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a, bm, bv;
      adam_one<T>(E::get(ug.e[j]), E::get(up.e[j]), E::get(um.e[j]), E::get(uv.e[j]), clip,
                  normT, c, a, bm, bv);
      rp.e[j] = E::put(a);
      rm.e[j] = E::put(bm);
      rv.e[j] = E::put(bv);
    }
    *reinterpret_cast<uint4*>(po + i0) = rp.w;
    *reinterpret_cast<uint4*>(mo + i0) = rm.w;
    *reinterpret_cast<uint4*>(vo + i0) = rv.w;
    return;
  }
  for (long long i = i0; i < i0 + V && i < L.n; ++i) {
    const float ne = n_tenants > 1 ? norms[int(i / L.per)] : norm;
    float a, bm, bv;
    adam_one<T>(E::get(g[i]), E::get(p[i]), E::get(m[i]), E::get(v[i]), !(ne < c.max_norm),
                E::rt(ne), c, a, bm, bv);
    po[i] = E::put(a);
    mo[i] = E::put(bm);
    vo[i] = E::put(bv);
  }
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(Leaves leaves, const float* __restrict__ norms, int n_tenants, Coef c) {
  const long long b = blockIdx.x;
  int li = 0;
  while (li + 1 < leaves.count && leaves.leaf[li + 1].first_block <= b) ++li;
  const Leaf& L = leaves.leaf[li];
  if (L.bf16)
    adam_leaf<uint16_t>(L, b, norms, n_tenants, c);
  else
    adam_leaf<float>(L, b, norms, n_tenants, c);
}

}  // namespace

// One launch over n_leaves leaves. ptrs: 7 pointers a leaf (g, p, m, v,
// p_out, m_out, v_out); sizes: elements a leaf, each a multiple of
// n_tenants; is_bf16: a leaf's dtype tag (1 bf16, 0 f32); norm: the
// n_tenants f32 global norms on the card (one for a solo update). bc1, bc2
// and step are f32 and rounded to each leaf's dtype in the kernel;
// max_norm, c1 = 1 - b1, b1, c2 = 1 - b2, b2 and eps stay f32.
extern "C" int adam_update_launch(const long long* ptrs, const long long* sizes,
                                  const int* is_bf16, int n_leaves, const void* norm,
                                  int n_tenants, float max_norm, float c1, float b1, float c2,
                                  float b2, float eps, float bc1, float bc2, float step,
                                  void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_tenants < 1) return int(cudaErrorInvalidValue);
  Leaves leaves;
  leaves.count = n_leaves;
  long long blocks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    Leaf& L = leaves.leaf[i];
    const long long* q = ptrs + 7 * i;
    L.g = reinterpret_cast<const void*>(q[0]);
    L.p = reinterpret_cast<const void*>(q[1]);
    L.m = reinterpret_cast<const void*>(q[2]);
    L.v = reinterpret_cast<const void*>(q[3]);
    L.po = reinterpret_cast<void*>(q[4]);
    L.mo = reinterpret_cast<void*>(q[5]);
    L.vo = reinterpret_cast<void*>(q[6]);
    L.n = sizes[i];
    if (L.n % n_tenants) return int(cudaErrorInvalidValue);
    L.per = L.n / n_tenants;
    L.bf16 = is_bf16[i] ? 1 : 0;
    L.first_block = blocks;
    const int V = L.bf16 ? Elt<uint16_t>::kVec : Elt<float>::kVec;
    const long long per_block = (long long)kThreads * V;
    int vec = int(n_tenants == 1 || L.per % V == 0);
    for (int j = 0; j < 7; ++j) vec &= int(q[j] % 16 == 0);
    L.vec = vec;
    blocks += (L.n + per_block - 1) / per_block;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const Coef c{max_norm, c1, b1, c2, b2, eps, bc1, bc2, step};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* nrm = static_cast<const float*>(norm);
  adam_update_kernel<<<unsigned(blocks), kThreads, 0, st>>>(leaves, nrm, n_tenants, c);
  return int(cudaGetLastError());
}

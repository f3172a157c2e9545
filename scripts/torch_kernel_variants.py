#!/usr/bin/env python3
"""Time variants of Hopper kernels' constants on one card, beside the
shipped build: the sorted-pair scatter (K10, ``csrc/scatter_rows.cu`` with
the work list of ``ops/sparse_grad.py``), the BatchTopK emit (K9,
``csrc/batchtopk.cu``), the row TopK masks (K5 ``csrc/topk_mask.cu``
and K7 ``csrc/topk_chunked.cu``, both routes, on ``csrc/topk_slice.cuh``),
the sparsify drain (K8), the int8 row quantize (K11) and the bf16 paged
attention (K1).

    python3 scripts/torch_kernel_variants.py [scatter] [emit] [topk] [sparsify] [quant] [attention]
    python3 scripts/torch_kernel_variants.py sparsify --csrc DIR
    python3 scripts/torch_kernel_variants.py attention --csrc DIR
    python3 scripts/torch_kernel_variants.py split --csrc DIR

from the root of a checkout, on a machine with an H100 and ``nvcc``. Each
variant is the shipped source with some constants or lines replaced (in
the ``.cu`` file or in a header), built with the flags of
``ops/_build.py`` into ``build/variants/`` and swapped in for the shipped
library; each result is checked bitwise against the plain version, then
timed with CUDA events over 20 launches, the variants in turns, twice.
The row TopK variants: K7's slice bytes (so its cluster size), a
lane-private first-pass histogram, warp-aggregated atomics, the load in 1
or 8 bulk copies, streaming stores, K5 on a persistent grid with two row
buffers a block, and two builds that stop early (the load alone; the load
and the select), which are timed, not checked. Shapes: K10 at the
main shape (4096 x 32 random pairs onto [32768, 4608] f32) and at the AuxK
filler shape (4096 x 64 pairs, no dead latent, onto [16384, 4608] f32);
the K9 emit at [4096, 32768] bf16 beside ``F.threshold``; K7 at bf16
[4096, 131072] and f32 [4096, 32768] and K5 at bf16 [4096, 32768] (k 32,
random normal rows, the training shapes), with K7's streaming route at
bf16 [512, 2^19]. The drain (K8, ``csrc/sparsify.cu``): its chunks a lane
a step and plain ``__ldg`` loads, each at 1, 2, 4 and 8 parts a row, on
TopK masks (k 32) at bf16 [4096, 32768] and [4096, 131072] and f32
[4096, 16384]; with ``--csrc`` of a tree holding the one-warp-a-row K8,
that kernel against rings of 2 and 4 chunks a lane. The int8 quantize
(K11, ``csrc/quantize_rows.cu``): K3's operand quantization at [4096,
4608] x [4608, 32768] split into its parts, the host time to issue a
row-route call, then the row route's loads a lane and grid and the
column route's occupancy and swizzle, at [8184, 2304] and on ``W2.t()``.
The paged attention (K1, ``csrc/paged_attention.cu``, bf16) at the serve
micro-batch [8, 1024] and the harvest chunk [4, 1024] (Gemma-2-2B's
heads): builds that leave out the softcap, the masks, P.V, Q.K^T or both
products (timed, not checked), a masked SDPA call and the bound, a
``torch.profiler`` split; with ``--csrc`` of a tree whose bf16 route is the
``mma.sync`` kernel over a page pool, that kernel as its wrapper called it
and on a pool built once.

``split`` times where the row TopK kernels of another source tree spend
their time (``--csrc``: its ``csrc`` directory, e.g. a parent commit's
unpacked with ``git archive``): K7's streaming kernel whole, without its
emit, with its first select pass alone, and with a warp-aggregated or a
single-copy histogram; K5's bisection kernel (the design before
``topk_slice.cuh``) as its stage alone, stage and bisection, and whole.
Builds that skip a phase write no output and are timed, not checked.
Prints one line a variant and shape."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KS8 = {"constexpr int kS = 16;": "constexpr int kS = 8;"}
KS4 = {"constexpr int kS = 16;": "constexpr int kS = 4;"}
DEFAULT_STORES = {"__stcs(reinterpret_cast<float4*>(o), ": "(*reinterpret_cast<float4*>(o) = "}
SCATTER = [
    ("shipped", {}, {}),
    ("kS 8", KS8, {}),
    ("kS 4", KS4, {}),
    ("T 512", {}, {"_T": 512}),
    ("T 128", {}, {"_T": 128}),
    ("T 1024 RB 64", {}, {"_T": 1024, "_RB": 64}),
    ("row order", {}, {"work_list": "row order"}),
    ("default stores", DEFAULT_STORES, {}),
]
EMIT_INDEX = "const long long i = (long long)blockIdx.x * kEmitThreads + threadIdx.x;"
EMIT_VEC = """    if (i < nv)
      __stcs(reinterpret_cast<uint4*>(out) + i,
             emit_vec(__ldg(reinterpret_cast<const uint4*>(h) + i), kth, kBf16));"""
EMIT_GRID = "(units + kEmitThreads - 1) / kEmitThreads"


def emit_unrolled(u: int) -> dict[str, str]:
    """The emit with ``u`` independent 16-byte loads a thread before its
    first store, a block for every ``u`` x 256 vectors (the vectored path
    only: the unaligned one would cover a ``u``-th of the entries)."""
    return {
        EMIT_INDEX: f"const long long i = (long long)blockIdx.x * kEmitThreads * {u} + threadIdx.x;",
        EMIT_VEC: f"""    uint4 u[{u}];
#pragma unroll
    for (int j = 0; j < {u}; ++j)
      if (i + j * kEmitThreads < nv)
        u[j] = __ldg(reinterpret_cast<const uint4*>(h) + i + j * kEmitThreads);
#pragma unroll
    for (int j = 0; j < {u}; ++j)
      if (i + j * kEmitThreads < nv)
        __stcs(reinterpret_cast<uint4*>(out) + i + j * kEmitThreads, emit_vec(u[j], kth, kBf16));""",
        EMIT_GRID: f"(units + kEmitThreads * {u} - 1) / (kEmitThreads * {u})",
    }


EMIT = [
    ("shipped", {}),
    ("2 loads a thread", emit_unrolled(2)),
    ("4 loads a thread", emit_unrolled(4)),
    ("8 loads a thread", emit_unrolled(8)),
    ("512 threads", {"constexpr int kEmitThreads = 256;": "constexpr int kEmitThreads = 512;"}),
    ("default stores", {"__stcs(reinterpret_cast<uint4*>(out) + i,":
                        "*(reinterpret_cast<uint4*>(out) + i) = ("}),
]


def build(name: str, label: str, subs: dict[str, str],
          header_subs: dict[str, dict[str, str]] | None = None,
          csrc: Path | None = None) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with ``subs`` replaced, and its headers with
    ``header_subs`` (``{header: subs}``), built into ``build/variants/``;
    ``csrc``: another source tree's ``csrc`` directory."""
    from crosscoder_tpu_torch.ops import _build

    csrc = csrc or _build.CSRC

    def replaced(path: Path, table: dict[str, str]) -> str:
        text = path.read_text()
        for old, new in table.items():
            if old not in text:
                raise SystemExit(f"{path.name} has no {old!r}")
            text = text.replace(old, new)
        return text

    out = ROOT / "build" / "variants"
    tag = f"{name}_" + "".join(c if c.isalnum() else "_" for c in label)
    inc = out / tag
    inc.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (inc / header.name).write_text(replaced(header, (header_subs or {}).get(header.name, {})))
    src = out / f"{tag}.cu"
    src.write_text(replaced(csrc / f"{name}.cu", subs))
    lib = out / f"{tag}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


QUEUE_CYCLES = 50_000_000    # a device sleep longer than the host takes to issue the launches


def time_ms(torch, fn, reps=20, queued=False):
    """Mean device time over ``reps`` launches back to back (CUDA events);
    ``queued``: behind a device sleep, so the events see the device alone."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_ms(torch, fn, reps=50):
    """Host time to issue one call of ``fn``, the card held busy by a device
    sleep so that no launch waits for it."""
    import time

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def scatter(torch) -> None:
    from crosscoder_tpu_torch.models.crosscoder import _exact_topk_indices
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import sparse_grad as sg

    gen = torch.Generator(device="cuda").manual_seed(8)
    B, m = 4096, 4608
    cf = torch.randn((B, 32), generator=gen, device="cuda")
    idx = torch.randint(0, 2 ** 15, (B, 32), generator=gen, device="cuda", dtype=torch.int32)
    h = torch.randn((B, 2 ** 14), generator=gen, device="cuda")
    aidx = _exact_topk_indices(torch.full_like(h, torch.finfo(h.dtype).min), 64)
    shapes = {"main": (cf, idx, 2 ** 15), "AuxK": (torch.zeros((B, 64), device="cuda"),
                                                   aidx, 2 ** 14)}
    rows = torch.randn((B, m), generator=gen, device="cuda")
    want = {k: sg.scatter_add_rows_plain(c, i, rows, n).view(torch.int32)
            for k, (c, i, n) in shapes.items()}
    with ThreadPoolExecutor(len(SCATTER)) as pool:
        built = list(pool.map(lambda v: build("scatter_rows", v[0], v[1]), SCATTER))
    libs = [(label, lib, py) for (label, _, py), lib in zip(SCATTER, built)]
    shipped_list = sg.work_list

    def row_order(dst_s, n_out):
        """The work list in row order, hot items not first."""
        items = shipped_list(dst_s, n_out)
        return items[torch.argsort(items[:, 0], stable=True)]

    defaults = {"_T": sg._T, "_RB": sg._RB, "work_list": shipped_list}
    for turn in range(2):
        for label, lib, py in libs:
            _build._libs["scatter_rows"] = _build.set_prototypes(lib, sg.PROTOTYPES)
            for k, v in {**defaults, **py}.items():
                setattr(sg, k, row_order if v == "row order" else v)
            for shape, (c, i, n) in shapes.items():
                same = torch.equal(sg.scatter_add_rows(c, i, rows, n).view(torch.int32),
                                   want[shape])
                ms = time_ms(torch, lambda: sg.scatter_add_rows(c, i, rows, n))
                print(f"K10 {shape} turn {turn} [{label}]: {ms:.4f} ms, bitwise "
                      f"{'equal' if same else 'DIFFERENT'}", flush=True)
    for k, v in defaults.items():
        setattr(sg, k, v)
    _build._libs.pop("scatter_rows")


def emit(torch) -> None:
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    gen = torch.Generator(device="cuda").manual_seed(10)
    h = torch.randn((4096, 2 ** 15), generator=gen, device="cuda").to(torch.bfloat16)
    kth = tp.batchtopk_select(h, tp.batchtopk_budget(h, 32))
    p = int(kth)
    t = float(torch.tensor([p - 1], dtype=torch.int16).view(torch.bfloat16))
    want = tp.batchtopk_emit_plain(h, kth).view(torch.int16)
    with ThreadPoolExecutor(len(EMIT)) as pool:
        built = list(pool.map(lambda v: build("batchtopk", v[0], v[1]), EMIT))
    libs = [(label, lib) for (label, _), lib in zip(EMIT, built)]
    for turn in range(2):
        lib_ms = time_ms(torch, lambda: torch.nn.functional.threshold(h, t, 0.0))
        print(f"K9 emit turn {turn} [F.threshold]: {lib_ms:.4f} ms", flush=True)
        for label, lib in libs:
            _build._libs["batchtopk"] = _build.set_prototypes(lib, tp.BATCHTOPK_PROTOTYPES)
            same = torch.equal(tp.batchtopk_emit(h, kth).view(torch.int16), want)
            ms = time_ms(torch, lambda: tp.batchtopk_emit(h, kth))
            print(f"K9 emit turn {turn} [{label}]: {ms:.4f} ms, bitwise "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
    _build._libs.pop("batchtopk")


# ---- the row TopK masks

# K7's streaming kernel (csrc/topk_chunked.cu, unchanged since it was the
# only route) and K5's bisection kernel (csrc/topk_mask.cu before the
# redesign): builds that end a phase early. `k > 0` always holds, so each
# skip is taken at run time while the compiler keeps the work before it.
SKIP_EMIT = {"    // ---- emit\n": "    if (k > 0) {   // the emit skipped\n      __syncthreads();\n"
                                       "      continue;\n    }\n"}
FIRST_PASS = {"radix_select.cuh": {"    if (remaining == eq) break;":
                                   "    if (remaining == eq || k > 0) break;"}}
AGG_COUNT = """#include "radix_select.cuh"

__device__ __forceinline__ void count_key_agg(unsigned v, int shift, unsigned mask,
                                              unsigned prefix, unsigned* hist) {
  const bool m = v != 0u && (v & mask) == prefix;
  const unsigned d = (v >> shift) & 0xFFu, lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, m ? d : 0x100u + lane);
  if (m && lane == unsigned(__ffs(peers) - 1)) atomicAdd(&hist[d], unsigned(__popc(peers)));
}
"""
STREAM_COUNT = "radix::count_key(min(key[u][j], kTopM1), shift, mask, prefix, mine);"
STREAM_SELECT = "radix::radix_select<kFirstShift, kWarps>("
SPLIT_K7 = [
    ("whole", {}, {}),
    ("select only", SKIP_EMIT, {}),
    ("first pass only", SKIP_EMIT, FIRST_PASS),
    ("aggregated atomics", {'#include "radix_select.cuh"\n': AGG_COUNT,
                            STREAM_COUNT: STREAM_COUNT.replace("radix::count_key", "count_key_agg")},
     {}),
    ("one histogram copy", {STREAM_SELECT: "radix::radix_select<kFirstShift, 1>("}, {}),
]
K5_STAGE_ONLY = {"  // bisection for v*, the k-th largest pattern:\n":
                 "  if (k > 0) {   // the bisection and the emit skipped\n"
                 "    if (tid == 0 && mx < 0) orow[0] = 0;\n    return;\n  }\n"}
K5_NO_EMIT = {"  // emit: one write of the row\n":
              "  if (k > 0) {   // the emit skipped\n"
              "    if (tid == 0 && cstar < -1) orow[0] = 0;\n    return;\n  }\n"}
SPLIT_K5 = [("stage only", K5_STAGE_ONLY), ("stage and bisection", K5_NO_EMIT), ("whole", {})]


def _topk_inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(9)
    return {"K7 bf16 [4096, 131072]": torch.randn((4096, 2 ** 17), generator=gen, device="cuda")
            .to(torch.bfloat16),
            "K7 f32 [4096, 32768]": torch.randn((4096, 2 ** 15), generator=gen, device="cuda"),
            "K5 bf16 [4096, 32768]": torch.randn((4096, 2 ** 15), generator=gen, device="cuda")
            .to(torch.bfloat16)}


def split(torch, csrc: Path) -> None:
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    hs = _topk_inputs(torch)
    k = 32
    with ThreadPoolExecutor(len(SPLIT_K7) + len(SPLIT_K5)) as pool:
        k7 = list(pool.map(lambda v: build("topk_chunked", v[0], v[1], v[2], csrc), SPLIT_K7))
        k5 = list(pool.map(lambda v: build("topk_mask", v[0], v[1], None, csrc), SPLIT_K5))
    for turn in range(2):
        for (label, *_), lib in zip(SPLIT_K7, k7):
            _build._libs["topk_chunked"] = _build.set_prototypes(
                lib, tp.MASK_PROTOTYPES["topk_chunked"])
            for shape in ("K7 bf16 [4096, 131072]", "K7 f32 [4096, 32768]"):
                h = hs[shape]
                bf16 = int(h.dtype == torch.bfloat16)

                def run():
                    return tp._launch_mask("topk_chunked", "topk_chunked_launch", h, k, (bf16,))

                check = ""
                if label in ("whole", "aggregated atomics", "one histogram copy"):
                    same = torch.equal(_int_view(torch, run()), _int_view(
                        torch, tp.topk_chunked_plain(h, k)))
                    check = f", bitwise {'equal' if same else 'DIFFERENT'}"
                print(f"split {shape} turn {turn} [streaming: {label}]: "
                      f"{time_ms(torch, run):.4f} ms{check}", flush=True)
        for (label, _), lib in zip(SPLIT_K5, k5):
            _build._libs["topk_mask"] = _build.set_prototypes(lib, tp.MASK_PROTOTYPES["topk_mask"])
            h = hs["K5 bf16 [4096, 32768]"]

            def run():
                return tp._launch_mask("topk_mask", "topk_mask_launch", h, k)

            check = ""
            if label == "whole":
                same = torch.equal(_int_view(torch, run()), _int_view(torch, tp.topk_plain(h, k)))
                check = f", bitwise {'equal' if same else 'DIFFERENT'}"
            print(f"split K5 bf16 [4096, 32768] turn {turn} [bisection: {label}]: "
                  f"{time_ms(torch, run):.4f} ms{check}", flush=True)
    _build._libs.pop("topk_chunked")
    _build._libs.pop("topk_mask")


SLICE = "topk_slice.cuh"
K5_LAUNCH = """extern "C" int topk_mask_launch(const void* h, void* out, int R, int W, int k, int vec,
                                void* stream) {
  return tslice::launch<true>(h, out, R, W, (W + 7) / 8 * 8, 1, k, vec,
                              static_cast<cudaStream_t>(stream));
}
"""
# K5 on a persistent grid with two row buffers a block: the next row's
# bulk copy runs while this row is selected and emitted (aligned rows only)
K5_DOUBLE_BUFFER = """namespace {

__global__ void __launch_bounds__(tslice::kThreads)
topk_mask_db_kernel(const uint16_t* __restrict__ h, uint16_t* __restrict__ out, int R, int W,
                    int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* buf = reinterpret_cast<uint16_t*>(smem);
  __shared__ tslice::Scratch<false> sc;
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  const uint32_t bytes = uint32_t(W) * 2u;
  if (tid == 0) {
    sm90::mbar_init(&bar[0], 1);
    sm90::mbar_init(&bar[1], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && int(blockIdx.x) < R) {
    sm90::mbar_expect_tx(&bar[0], bytes);
    sm90::bulk_load(buf, h + size_t(blockIdx.x) * W, bytes, &bar[0]);
  }
  int it = 0;
  for (int row = blockIdx.x; row < R; row += gridDim.x, ++it) {
    const int b = it & 1;
    const int next = row + gridDim.x;
    if (tid == 0 && next < R) {
      sm90::mbar_expect_tx(&bar[b ^ 1], bytes);
      sm90::bulk_load(buf + (b ^ 1) * W, h + size_t(next) * W, bytes, &bar[b ^ 1]);
    }
    sm90::mbar_wait(&bar[b], (it >> 1) & 1);
    tslice::mask_slice<true, false>(buf + b * W, out + size_t(row) * W, W, k, 1, 0u, 1u, sc,
                                    tslice::Arrival{nullptr, 0});
    __syncthreads();
  }
}

}  // namespace

extern "C" int topk_mask_launch(const void* h, void* out, int R, int W, int k, int vec,
                                void* stream) {
  if (!vec) return int(cudaErrorInvalidValue);
  if (R == 0 || W == 0) return 0;
  const size_t smem = 4 * size_t(W);
  cudaError_t err = cudaFuncSetAttribute(topk_mask_db_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_mask_db_kernel, tslice::kThreads,
                                                smem);
  const int grid = min(R, sms * max(per_sm, 1));
  topk_mask_db_kernel<<<grid, tslice::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(h), static_cast<uint16_t*>(out), R, W, k);
  return int(cudaGetLastError());
}
"""
# the first select pass counted into lane-private 16-bit counters (a word
# for each pair of digits and lane, so a warp's atomics never share an
# address; its keys are below 2^31 or 2^15, so 128 digits), summed into the
# pass's histogram, in place of one atomic a key into the histogram
SHARED_COUNT = """#pragma unroll
      for (int j = 0; j < 8; ++j)
        radix::count_key(min(key[j], R::kTopM1), shift, mask, prefix, hist);
    }
  };
"""
LANE_COUNT = """#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned v = min(key[j], R::kTopM1);
        if (!first)
          radix::count_key(v, shift, mask, prefix, hist);
        else if (v != 0u)
          atomicAdd(&sc.lanes[(v >> (shift + 1)) * 32 + lane], 1u << (((v >> shift) & 1u) * 16));
      }
    }
    if (first) {
      __syncthreads();
      if (tid < 128) {
        const int w = tid >> 1, half = (tid & 1) * 16;
        unsigned c = 0;
        for (int l = 0; l < 32; ++l) c += (sc.lanes[w * 32 + ((l + w) & 31)] >> half) & 0xFFFFu;
        hist[tid] = c;
      }
    }
  };
"""
LANE_FIRST = {"  unsigned hist[(kCluster ? 2 : 1) * kBins];\n":
              "  unsigned hist[(kCluster ? 2 : 1) * kBins];\n  unsigned lanes[64 * 32];\n",
              "  if (tid < kMaxStretches) sc.stretch[tid] = 0;\n":
              "  if (tid < kMaxStretches) sc.stretch[tid] = 0;\n"
              "  for (int i = tid; i < 64 * 32; i += kThreads) sc.lanes[i] = 0;\n",
              SHARED_COUNT: LANE_COUNT}
# builds of topk_slice.cuh that stop early (timed, their output not
# checked): the slice loaded, or loaded and selected, and nothing written
LOAD_ONLY = """  if (k > 0) {   // the select and the emit skipped
    for (int i = 0; vec && i < kLoadChunks; ++i) sm90::mbar_wait(&bar[i], 0);
    return;
  }
  mask_slice<BF16, kCluster>(slice,"""
SKIP_SLICE_EMIT = """  if (k > 0) {   // the emit skipped
    if (kCluster) sm90::cluster_sync();
    return;
  }
"""
# (label, header substitutions, module constants, topk_mask.cu substitutions)
TOPK = [
    ("shipped", {}, {}, {}),
    ("32 KB slices", {}, {"_SLICE_BYTES": 32 * 1024}, {}),
    ("96 KB slices", {}, {"_SLICE_BYTES": 96 * 1024}, {}),
    ("128 KB slices", {}, {"_SLICE_BYTES": 128 * 1024}, {}),
    ("lane-private first pass", {SLICE: LANE_FIRST}, {}, {}),
    ("aggregated atomics", {SLICE: {'#include "radix_select.cuh"\n': AGG_COUNT,
                                    SHARED_COUNT: SHARED_COUNT.replace("radix::count_key",
                                                                       "count_key_agg")}}, {}, {}),
    ("load only", {SLICE: {"  mask_slice<BF16, kCluster>(slice,": LOAD_ONLY}}, {}, {}),
    ("load and select", {SLICE: {"  // ---- emit:": SKIP_SLICE_EMIT + "  // ---- emit:"}}, {}, {}),
    ("1 load chunk", {SLICE: {"constexpr int kLoadChunks = 4;": "constexpr int kLoadChunks = 1;"}},
     {}, {}),
    ("8 load chunks", {SLICE: {"constexpr int kLoadChunks = 4;": "constexpr int kLoadChunks = 8;"}},
     {}, {}),
    ("streaming stores", {SLICE: {"      *reinterpret_cast<uint4*>(r + c) = d.u;":
                                  "      __stcs(reinterpret_cast<uint4*>(r + c), d.u);",
                                  "      *reinterpret_cast<uint4*>(r + c) = make_uint4("
                                  "o[0], o[1], o[2], o[3]);":
                                  "      __stcs(reinterpret_cast<uint4*>(r + c), make_uint4("
                                  "o[0], o[1], o[2], o[3]));",
                                  "      *reinterpret_cast<uint4*>(r + c + 4) = make_uint4("
                                  "o[4], o[5], o[6], o[7]);":
                                  "      __stcs(reinterpret_cast<uint4*>(r + c + 4), make_uint4("
                                  "o[4], o[5], o[6], o[7]));"}}, {}, {}),
    ("K5 double buffer", {}, {}, {K5_LAUNCH: K5_DOUBLE_BUFFER}),
]


def topk(torch) -> None:
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    hs = _topk_inputs(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    hs["K7 streaming bf16 [512, 524288]"] = torch.randn(
        (512, 2 ** 19), generator=gen, device="cuda").to(torch.bfloat16)
    k = 32
    want = {s: _int_view(torch, (tp.topk_plain if s.startswith("K5") else tp.topk_chunked_plain)(
        h, k)) for s, h in hs.items()}
    with ThreadPoolExecutor(2 * len(TOPK)) as pool:
        k7 = list(pool.map(lambda v: build("topk_chunked", v[0], {}, v[1]), TOPK))
        k5 = list(pool.map(lambda v: build("topk_mask", v[0], v[3], v[1]), TOPK))
    shipped = {n: getattr(tp, n) for n in ("_SLICE_BYTES",)}
    for turn in range(2):
        for (label, _, py, _), lib7, lib5 in zip(TOPK, k7, k5):
            _build._libs["topk_chunked"] = _build.set_prototypes(
                lib7, tp.MASK_PROTOTYPES["topk_chunked"])
            _build._libs["topk_mask"] = _build.set_prototypes(lib5, tp.MASK_PROTOTYPES["topk_mask"])
            for n, v in {**shipped, **py}.items():
                setattr(tp, n, v)
            for shape, h in hs.items():
                fn = tp.topk_mask if shape.startswith("K5") else tp.topk_chunked
                plan = "" if shape.startswith("K5") else f" {tp.topk_plan(h.shape[-1], h.dtype)}"
                check = ""
                if label not in ("load only", "load and select"):
                    same = torch.equal(_int_view(torch, fn(h, k)), want[shape])
                    check = f", bitwise {'equal' if same else 'DIFFERENT'}"
                ms = time_ms(torch, lambda: fn(h, k))
                print(f"{shape} turn {turn} [{label}]{plan}: {ms:.4f} ms{check}", flush=True)
    for n, v in shipped.items():
        setattr(tp, n, v)
    _build._libs.pop("topk_chunked")
    _build._libs.pop("topk_mask")


# ---- the sparsify drain (K8) and the int8 row quantize (K11)

# K8's earlier design (one warp a row, one chunk of 8 entries a lane in
# flight, the next prefetched) turned into a ring of `u` chunks a lane a step, all `u`
# loads (and the next step's `u`) issued before the first is drained
RING_FROM, RING_TO = "  Chunk<T> cur, nxt;\n", "    cur = nxt;\n  }\n"


def ring(csrc: Path, u: int) -> dict[str, str]:
    text = (csrc / "sparsify.cu").read_text()
    a = text.index(RING_FROM)
    old = text[a:text.index(RING_TO, a) + len(RING_TO)]
    body = old[old.index("    unsigned m = 0;\n"):old.index("    cur = nxt;\n")]
    body = body.replace("cur.", "cur[u].").replace("\n    ", "\n      ").replace("    unsigned m", "      unsigned m", 1)
    new = f"""  constexpr int kU = {u};
  Chunk<T> cur[kU], nxt[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) load_chunk(cur[u], fr, lane * 8 + u * 256, W, vec);
  for (int base0 = 0; base0 < W; base0 += 256 * kU) {{
    if (base0 + 256 * kU < W) {{
#pragma unroll
      for (int u = 0; u < kU; ++u)
        load_chunk(nxt[u], fr, base0 + 256 * kU + u * 256 + lane * 8, W, vec);
    }}
#pragma unroll
    for (int u = 0; u < kU; ++u) {{
      const int base = base0 + u * 256;
      const int c = base + lane * 8;
{body}    }}
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }}
"""
    return {old: new}


def _drain_inputs(torch):
    """The main path's K8 inputs: TopK masks (k 32) of random normal rows."""
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    gen = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    for R, W, dt in ((4096, 2 ** 15, torch.bfloat16), (4096, 2 ** 17, torch.bfloat16),
                     (4096, 2 ** 14, torch.float32)):
        h = torch.randn((R, W), generator=gen, device="cuda").to(dt)
        out[f"K8 {str(dt)[6:]} [{R}, {W}]"] = tp.topk(h, 32)
        del h
    return out


def _warp_row_sparsify(torch, lib, f, k):
    """A launch of the earlier one-warp-a-row K8 library (its C signature:
    no parts)."""
    fn = lib.sparsify_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    R, W = f.shape
    vals = torch.empty((R, k), dtype=f.dtype, device=f.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=f.device)
    fn(f.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, W, k, int(f.dtype == torch.bfloat16),
       int(W % 8 == 0), torch.cuda.current_stream().cuda_stream)
    return vals, idx


# the shipped K8's constants: chunks a lane a step (bf16, f32), and plain
# `__ldg` loads in place of its L1-bypassing loads with a 256-byte L2 hint
LDG_L2 = """  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
"""
LDG = "  return __ldg(reinterpret_cast<const uint4*>(p));\n"


def k_u(bf16: int, f32: int) -> dict[str, str]:
    return {"  static constexpr int kU = 4;": f"  static constexpr int kU = {bf16};",
            "  static constexpr int kU = 2;": f"  static constexpr int kU = {f32};"}


SPARSIFY = [("shipped", {}), ("kU 1/1", k_u(1, 1)), ("kU 2/1", k_u(2, 1)),
            ("__ldg loads", {LDG_L2: LDG})]


def sparsify(torch, csrc: Path | None) -> None:
    """K8 variants on the main path's three shapes, each bitwise against
    the plain version. With ``csrc`` holding the earlier one-warp-a-row kernel:
    that kernel and rings of 2 and 4 chunks a lane. Otherwise the shipped
    kernel's constants (``SPARSIFY``), each at 1, 2, 4 and 8 parts a row."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    csrc = csrc or _build.CSRC
    warp_row = RING_FROM in (csrc / "sparsify.cu").read_text()
    fs = _drain_inputs(torch)
    k = 32
    want = {s: tuple(_int_view(torch, t) for t in tp.sparsify_plain(f, k)) for s, f in fs.items()}
    variants = ([("one chunk a lane (warp a row)", {}), ("ring of 2", ring(csrc, 2)),
                 ("ring of 4", ring(csrc, 4))] if warp_row else SPARSIFY)
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(lambda v: build("sparsify", v[0], v[1], None, csrc), variants))
    plan = tp.sparsify_plan
    for turn in range(2):
        for (label, _), lib in zip(variants, libs):
            for parts in ((1,) if warp_row else (1, 2, 4, 8)):
                if warp_row:
                    run = lambda f: _warp_row_sparsify(torch, lib, f, k)   # noqa: E731
                else:
                    _build._libs["sparsify"] = _build.set_prototypes(lib, tp._SPARSIFY_PROTOTYPES)
                    tp.sparsify_plan = lambda W, kk, dt, P=parts: (
                        ("split", P, tp._slice_cols(W, P)) if P > 1 else ("warp", 1, W))
                    run = lambda f: tp.sparsify(f, k)                  # noqa: E731
                for shape, f in fs.items():
                    got = tuple(_int_view(torch, t) for t in run(f))
                    same = all(torch.equal(a, b) for a, b in zip(got, want[shape]))
                    ms = time_ms(torch, lambda: run(f))
                    tag = "" if warp_row else f", {parts} parts"
                    print(f"{shape} turn {turn} [{label}{tag}]: {ms:.4f} ms, bitwise "
                          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    tp.sparsify_plan = plan
    _build._libs.pop("sparsify", None)


# the shipped K11's constants: the row route's 16-byte loads a lane (bf16
# and f32) and its grid (sized to the SMs, or a block for every 8 warps'
# units), the column route held to 3 or 4 blocks an SM, and its shared
# memory's words XOR-swizzled by the column's load group (no two lanes of
# a packing or a reading warp on one bank)
KMAX16 = "  static constexpr int kMax = 4;               // row route: 16-byte loads a lane holds"
KMAX32 = "  static constexpr int kN = 4;\n  static constexpr int kMax = 4;"
GRID = "const int grid = int(want < grid_max ? want : grid_max);"
COLS = "__launch_bounds__(kThreads)\nquantize_cols_kernel"
QUANT = [("shipped", {}),
         ("row: 2 loads a lane", {KMAX16: KMAX16.replace("4;", "2;"),
                                  KMAX32: KMAX32.replace("kMax = 4;", "kMax = 2;")}),
         ("row: 8 loads a lane", {KMAX16: KMAX16.replace("4;", "8;"),
                                  KMAX32: KMAX32.replace("kMax = 4;", "kMax = 8;")}),
         ("row: a block for every 8 warps' units", {GRID: "const int grid = int(want);"}),
         ("column: 4 blocks an SM", {COLS: COLS.replace("(kThreads)", "(kThreads, 4)")}),
         ("column: 3 blocks an SM", {COLS: COLS.replace("(kThreads)", "(kThreads, 3)")}),
         ("column: swizzled words", {"qt[(cg * kV + e) * 64 + rq + 32 * i] = w;":
                                     "qt[(cg * kV + e) * 64 + ((rq + 32 * i) ^ (cg << 2))] = w;",
                                     "qt[c * 64 + w]": "qt[c * 64 + (w ^ ((c / kV) << 2))]"})]


def quant(torch, csrc: Path | None = None) -> None:
    """K3's operand quantization at leg I's shape (x [4096, 4608], W [4608,
    32768] bf16, block 256) split into its parts, and K11 at leg Q's shape
    ([8184, 2304] bf16): back to back, queued behind a device sleep, and
    the host's time to issue one call; then, on a tree with K11's column
    route, the shipped K11's constants (``QUANT``) at both shapes, each
    bitwise against the plain version."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import quant as q

    gen = torch.Generator(device="cuda").manual_seed(13)
    nd, H, qb = 4608, 2 ** 15, 256
    x = torch.randn((4096, nd), generator=gen, device="cuda").to(torch.bfloat16)
    W = (torch.randn((nd, H), generator=gen, device="cuda") * nd ** -0.5).to(torch.bfloat16)
    Wc = W.t().contiguous()
    parts = q.quantize_contraction(x, W, qb)
    real = q.quantize_contraction

    def reshuffles():
        q.quantize_contraction = lambda *a: parts
        try:
            return fek.q_operands(x, W, qb)
        finally:
            q.quantize_contraction = real

    for turn in range(2):
        for label, fn in (("W2.t().contiguous()", lambda: W.t().contiguous()),
                          ("K11 on x", lambda: q.quantize_rows(x, qb)),
                          ("K11 on the copied W", lambda: q.quantize_rows(Wc, qb)),
                          ("quantize_rows(W2.t())", lambda: q.quantize_rows(W.t(), qb)),
                          ("the xsT/ws reshuffles", reshuffles),
                          ("q_operands", lambda: fek.q_operands(x, W, qb))):
            print(f"q_operands split turn {turn} [{label}]: {time_ms(torch, fn, 10):.4f} ms",
                  flush=True)
    xq = (torch.randn((8184, 2304), generator=gen, device="cuda") * 3).to(torch.bfloat16)
    for turn in range(2):
        run = lambda: q.quantize_rows(xq, qb)   # noqa: E731
        print(f"K11 [8184, 2304] turn {turn}: {time_ms(torch, run, 50):.4f} ms back to back, "
              f"{time_ms(torch, run, 50, queued=True):.4f} ms queued, host {host_ms(torch, run, 50):.4f} "
              f"ms a call", flush=True)

    variants = QUANT if "quantize_cols_launch" in (csrc or _build.CSRC).joinpath(
        "quantize_rows.cu").read_text() else []
    with ThreadPoolExecutor(max(1, len(variants))) as pool:
        libs = list(pool.map(lambda v: build("quantize_rows", v[0], v[1]), variants))
    want_x = q.quantize_blocks(xq, qb)
    want_w = q.quantize_blocks(W.t(), qb)
    for turn in range(2):
        for (label, _), lib in zip(variants, libs):
            _build._libs["quantize_rows"] = _build.set_prototypes(lib, q._PROTOTYPES)
            for shape, x_, want in (("row route [8184, 2304]", xq, want_x),
                                    ("column route W.t() [32768, 4608]", W.t(), want_w)):
                got = q.quantize_rows(x_, qb)
                same = torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32))
                ms = time_ms(torch, lambda: q.quantize_rows(x_, qb), 20)
                qms = time_ms(torch, lambda: q.quantize_rows(x_, qb), 20, queued=True)
                print(f"K11 {shape} turn {turn} [{label}]: {ms:.4f} ms, {qms:.4f} ms queued, "
                      f"bitwise {'equal' if same else 'DIFFERENT'}", flush=True)
    _build._libs.pop("quantize_rows", None)


# ---- the paged attention (K1, bf16)

# builds of csrc/paged_attention.cu that leave a phase of the bf16 kernel
# out: timed, not checked
K1_SOFTCAP = "      if constexpr (kCap) x = softcap_of(x, softcap, inv_cap);\n"
K1_MASKS = "    const uint32_t vis_a = visible_bits(ta), vis_b = visible_bits(tb);"
K1_PV = "        wgmma_rs_n128(o[n], a, dv + (n * 2 * Sh::kPageBox + kk * 2048) / 16);\n"
K1_QK = """      wgmma_qk<PAGE>(s, dq + ((kk >> 2) * kQBox + (kk & 3) * 32) / 16,
                     dk + ((kk >> 2) * Sh::kPageBox + (kk & 3) * 32) / 16);\n"""
K1_SPLIT = [
    ("shipped", {}),
    ("no softcap", {K1_SOFTCAP: ""}),
    ("no masks", {K1_MASKS: "    const uint32_t vis_a = ~0u, vis_b = ~0u;"}),
    ("no P.V", {K1_PV: "        ;\n"}),
    ("no Q.K^T", {K1_QK: "      ;\n"}),
    ("loads and softmax only", {K1_PV: "        ;\n", K1_QK: "      ;\n"}),
]


def _k1_shapes(np):
    """K1's two main-path shapes at Gemma-2-2B's attention (8 heads over 4
    KV heads of 256, page 64, scale 1/16, softcap 50): the serve micro-batch
    (8 documents of 1024 at chip_smoke.py's serve lengths) and the harvest
    chunk (4 x 1024 at the lengths of its corpus's first chunk)."""
    from chip_smoke import HARVEST, harvest_tokens
    from crosscoder_tpu_torch.data.tokens import valid_lengths

    rng = np.random.default_rng(3)
    serve = [1, 1024] + [int(n) for n in rng.integers(2, 1024, size=6)]
    chunk = harvest_tokens(np, 256, HARVEST["seq_len"], 256_000, 6)[:HARVEST["model_batch_size"]]
    return {"serve [8, 1024]": serve, "harvest [4, 1024]": [int(n) for n in valid_lengths(chunk)]}


def attention(torch, csrc: Path | None) -> None:
    """K1 bf16 at its two main-path shapes: the shipped kernel, the
    builds of K1_SPLIT, and (``csrc``: a tree whose kernels read a page
    pool, its bf16 route the ``mma.sync`` kernel) that tree's kernel,
    called as its wrapper called it (``paginate_kv`` then the launch) and
    alone on a pool built once; beside one masked SDPA call and the bound.
    In turns: the old tree, the shipped kernel, the shipped kernel, the old
    tree. Then the f32 route at the serve shape, the shipped kernel against
    the old tree's."""
    import numpy as np

    from chip_smoke import PEAK_BYTES_S, PEAK_OPS_S
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.ops import paged_attention as pa

    H, KV, hd, page, S = 8, 4, 256, 64, 1024
    kw = dict(page_size=page, scale=256 ** -0.5, softcap=50.0, window=0)
    with ThreadPoolExecutor(len(K1_SPLIT) + 1) as pool:
        futs = [pool.submit(build, "paged_attention", label, subs) for label, subs in K1_SPLIT]
        old_f = pool.submit(build, "paged_attention", "pool", {}, csrc=csrc) if csrc else None
        split_libs = [(label, f.result()) for (label, _), f in zip(K1_SPLIT, futs)]
        old = _build.set_prototypes(old_f.result(), pa._PROTOTYPES) if old_f else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = _k1_shapes(np)
    cases = [(s_, n_, torch.bfloat16) for s_, n_ in shapes.items()]
    cases.append(("serve [8, 1024]", shapes["serve [8, 1024]"], torch.float32))
    for shape, lengths, dt in cases:
        bf = dt == torch.bfloat16
        shape = f"{shape} {str(dt)[6:]}"
        D = len(lengths)
        gen = torch.Generator(device="cuda").manual_seed(26)
        q = torch.randn((D, S, H, hd), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((D, S, KV, hd), generator=gen, device="cuda").to(dt)
                for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        want = pa.paged_attention_plain(q, k, v, lens, **kw).float()

        def err(out):
            return max(float((out.float()[d, :n] - want[d, :n]).abs().max())
                       for d, n in enumerate(lengths) if n)

        def old_call(pool_=None):
            kv_pages, tbl = pool_ or pa.paginate_kv(k, v, page)
            out = torch.empty_like(q)
            _build.check(old.rpa_launch(q.data_ptr(), kv_pages.data_ptr(), tbl.data_ptr(),
                                        lens.data_ptr(), out.data_ptr(), D, S, H, KV, hd, page,
                                        int(bf), kw["scale"], kw["softcap"], 0,
                                        _build.stream(q.device)),
                         "the old tree's paged attention")
            return out.reshape(D, S, H * hd)

        pos = torch.arange(S, device="cuda")
        mask = ((pos[None, :, None] >= pos[None, None, :])
                & (pos[None, None, :] < lens[:, None, None].long()))[:, None]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pairs = sum(t + 1 for n in lengths for t in range(n))
        n_tok = sum(lengths)
        b_bytes = (n_tok * (2 * H + 2 * KV) * hd * q.element_size() + D * 4) / PEAK_BYTES_S * 1e3
        b_ops = 4 * hd * H * pairs / PEAK_OPS_S["bf16" if bf else "fp32"] * 1e3
        print(f"K1 {shape} lengths {lengths}: bound {max(b_bytes, b_ops):.4f} ms "
              f"(bytes {b_bytes:.4f}, operations {b_ops:.4f})", flush=True)
        shipped = pa.paged_attention(q, k, v, lens, **kw)
        print(f"K1 {shape}: shipped max_abs_err {err(shipped):.3e}"
              + (f", old tree {err(old_call()):.3e}" if old else ""), flush=True)
        pool_ = pa.paginate_kv(k, v, page) if old else None
        turns = ["old", "new", "new", "old"] if old else ["new", "new"]
        for turn, who in enumerate(turns):
            if who == "old":
                ms = time_ms(torch, old_call)
                alone = time_ms(torch, lambda: old_call(pool_))
                pg = time_ms(torch, lambda: pa.paginate_kv(k, v, page))
                print(f"K1 {shape} turn {turn} [old tree]: {ms:.4f} ms as its wrapper "
                      f"called it, {alone:.4f} ms on a pool built once, paginate_kv alone "
                      f"{pg:.4f} ms", flush=True)
                continue
            for label, lib in split_libs if bf else split_libs[:1]:
                _build._libs["paged_attention"] = _build.set_prototypes(lib, pa._PROTOTYPES)
                ms = time_ms(torch, lambda: pa.paged_attention(q, k, v, lens, **kw))
                print(f"K1 {shape} turn {turn} [{label}]: {ms:.4f} ms", flush=True)
            lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                                                 enable_gqa=True))
            print(f"K1 {shape} turn {turn} [sdpa, explicit mask, no softcap]: {lib_ms:.4f} ms",
                  flush=True)
        _build._libs.pop("paged_attention", None)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pa.paged_attention(q, k, v, lens, **kw)
                if old:
                    old_call()
            torch.cuda.synchronize()
        for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:8]:
            print(f"K1 {shape} profile: {e.key[:90]} x{e.count}: "
                  f"{e.self_device_time_total / e.count / 1e3:.4f} ms a call", flush=True)
        del q, k, v, qt, kt, vt, mask, want, pool_


def _int_view(torch, t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"device: {card}", flush=True)
    args = sys.argv[1:]
    if "split" in args:
        if "--csrc" not in args:
            raise SystemExit("split needs --csrc DIR: the source tree whose kernels it splits")
        split(torch, Path(args[args.index("--csrc") + 1]).resolve())
        return 0
    csrc = Path(args[args.index("--csrc") + 1]).resolve() if "--csrc" in args else None
    which = args or ["scatter", "emit", "topk", "sparsify", "quant", "attention"]
    if "scatter" in which:
        scatter(torch)
    if "emit" in which:
        emit(torch)
    if "topk" in which:
        topk(torch)
    if "sparsify" in which:
        sparsify(torch, csrc)
    if "quant" in which:
        quant(torch, csrc)
    if "attention" in which:
        attention(torch, csrc)
    return 0


if __name__ == "__main__":
    sys.exit(main())

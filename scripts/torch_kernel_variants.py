#!/usr/bin/env python3
"""Time variants of two Hopper kernels' constants on one card, beside the
shipped build: the sorted-pair scatter (K10, ``csrc/scatter_rows.cu`` with
the work list of ``ops/sparse_grad.py``) and the BatchTopK emit (K9,
``csrc/batchtopk.cu``).

    python3 scripts/torch_kernel_variants.py [scatter] [emit]

from the root of a checkout, on a machine with an H100 and ``nvcc``. Each
variant is the shipped source with some constants replaced, built with the
flags of ``ops/_build.py`` into ``build/variants/`` and swapped in for the
shipped library; each result is checked bitwise against the plain
version, then timed with CUDA events over 20 launches, the variants in
turns, twice. Shapes: K10 at the main shape (4096 x 32 random pairs onto
[32768, 4608] f32) and at the AuxK filler shape (4096 x 64 pairs, no dead
latent, onto [16384, 4608] f32); the K9 emit at [4096, 32768] bf16 beside
``F.threshold``. Prints one line a variant and shape."""

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


def build(name: str, label: str, subs: dict[str, str]) -> ctypes.CDLL:
    from crosscoder_tpu_torch.ops import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in subs.items():
        if old not in text:
            raise SystemExit(f"{name}.cu has no {old!r}")
        text = text.replace(old, new)
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in label)
    src = out / f"{name}_{tag}.cu"
    src.write_text(text)
    lib = out / f"{name}_{tag}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def time_ms(torch, fn, reps=20):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


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
            _build._libs["scatter_rows"] = lib
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
            _build._libs["batchtopk"] = lib
            same = torch.equal(tp.batchtopk_emit(h, kth).view(torch.int16), want)
            ms = time_ms(torch, lambda: tp.batchtopk_emit(h, kth))
            print(f"K9 emit turn {turn} [{label}]: {ms:.4f} ms, bitwise "
                  f"{'equal' if same else 'DIFFERENT'}", flush=True)
    _build._libs.pop("batchtopk")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"device: {card}", flush=True)
    which = sys.argv[1:] or ["scatter", "emit"]
    if "scatter" in which:
        scatter(torch)
    if "emit" in which:
        emit(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())

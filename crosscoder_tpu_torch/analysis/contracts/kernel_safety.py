"""Kernel launch safety over the hand-written Hopper kernels: the port's
counterpart of :mod:`crosscoder_tpu.analysis.contracts.pallas_safety`.

The JAX package records every ``pallas_call``'s grid, BlockSpecs and
scratch as the TPU would issue them and checks them statically. The
port's kernels are CUDA C++ launched through ctypes, so its launches are
captured on the card as they happen: :func:`run_kernel_probes` calls each
wrapper's real entry point for every library of ``_build.kernel_names()``,
at its main-path shape (a ``PERF.md`` §6 row) and at a tail shape whose
dimensions are not multiples of the kernel's tile but which the wrapper
accepts, over each of the wrapper's routes, under ``torch.profiler`` with
CUDA activity. From the exported trace each launch's ``grid``, ``block``,
``registers per thread`` and ``shared memory`` give a
:class:`CapturedLaunch`. Device limits come from
``torch.cuda.get_device_properties`` (and CUDA's architectural limits
where torch does not expose one), spills from the compile tier's ptxas
report (``_build.library_cost``). Each tail probe then runs twice more on
the card and once through its plain version on the CPU (the same wrapper
on CPU tensors), and ``compute-sanitizer``'s ``memcheck`` and
``racecheck`` run the tail probes in a child process with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` (the caching allocator would hide an
out-of-bounds write inside a pooled segment).

The six rules, one to one with JAX's, are pure functions of
:class:`KernelContext`:

- **kernel-probe-coverage**: every library probed, and every
  ``__global__`` of its ptxas report (by name, not by template instance)
  launched by some probe; a probe that raises is a finding;
- **kernel-launch-limits**: threads per block and grid dimensions within
  the device's limits;
- **kernel-smem-budget**: static + dynamic shared memory within
  ``shared_memory_per_block_optin``, and registers × threads within
  ``regs_per_multiprocessor`` (one block fits an SM);
- **kernel-tail-oob**: ``memcheck`` clean over the tail probes, and each
  tail probe meets its kernel's bar against the plain version;
- **kernel-write-race**: ``racecheck`` clean, and each tail probe gives
  bitwise the same output twice;
- **kernel-local-memory**: spill stores and loads from ptxas, at severity
  ``warning`` (spills cost time, not correctness).

The pack runs on the card only: on the CPU no kernel launches, so every
rule lands in ``Report.skipped`` with that reason, never in ``checked``.
Where ``compute-sanitizer`` is not installed beside ``nvcc``, the two
sanitizer rules are skipped with that reason.

``python -m crosscoder_tpu_torch.analysis.contracts.kernel_safety
--tail-probes`` runs the tail probes once each on the card: the child the
sanitizers wrap.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from crosscoder_tpu_torch.analysis.contracts.engine import Finding, Rule

# CUDA's architectural launch limits (compute capability 3.0 and later),
# for the fields torch's device properties do not carry
CUDA_MAX_BLOCK = (1024, 1024, 64)
CUDA_MAX_GRID = ((1 << 31) - 1, 65535, 65535)
SANITIZER_TOOLS = ("memcheck", "racecheck")
SANITIZER_RULES = {"memcheck": "kernel-tail-oob", "racecheck": "kernel-write-race"}
CPU_REASON = "the kernel pack runs on cuda only: on the CPU no kernel launches"
K1_TOL = {"bfloat16": 2e-2, "float32": 1e-5}     # PERF.md §2's K1 bars
_MODULE = "crosscoder_tpu_torch.analysis.contracts.kernel_safety"    # the children's entry
CHILD_TIMEOUT_S = 900.0          # the capture process's and each sanitizer run's limit


@dataclass
class CapturedLaunch:
    """One kernel launch as the profiler's trace recorded it."""

    library: str                 # the library the kernel's name belongs to
    kernel: str                  # base name (no namespace, no template)
    probe: str                   # the probe that launched it
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    registers: int               # per thread
    smem_bytes: int              # static + dynamic shared memory
    occupancy: float | None = None   # the trace's estimated achieved occupancy %
    cluster: int = 1             # blocks a cluster (K7's cluster route: its plan)

    @property
    def threads(self) -> int:
        return math.prod(self.block)


@dataclass
class DeviceLimits:
    """The card's launch limits."""

    max_threads_per_block: int = 1024
    max_block: tuple[int, int, int] = CUDA_MAX_BLOCK
    max_grid: tuple[int, int, int] = CUDA_MAX_GRID
    smem_per_block_optin: int = 232448
    smem_per_sm: int = 233472
    regs_per_sm: int = 65536
    max_threads_per_sm: int = 2048


@dataclass
class KernelContext:
    """Everything the kernel rules read: captured launches, the libraries
    to cover and the ``__global__`` base names of each (from ptxas), probe
    faults, device limits, ptxas's per-function report, sanitizer results
    (``None``: not run), the tail probes' bar and repeat checks."""

    launches: list[CapturedLaunch] = field(default_factory=list)
    libraries: tuple[str, ...] = ()
    globals: dict[str, set[str]] = field(default_factory=dict)
    probe_errors: dict[str, str] = field(default_factory=dict)
    limits: DeviceLimits = field(default_factory=DeviceLimits)
    # library -> base name -> {registers, smem_bytes, spill_stores, spill_loads}
    ptxas: dict[str, dict[str, dict[str, int]]] = field(default_factory=dict)
    sanitizer: dict[str, dict[str, Any] | None] = field(default_factory=dict)
    # tail probe -> (ok, detail): its bar against the plain version
    tail_bars: dict[str, tuple[bool, str]] = field(default_factory=dict)
    # tail probe -> bitwise the same output twice
    repeats: dict[str, bool] = field(default_factory=dict)
    skip_reasons: dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# kernel names


def base_name(name: str) -> str:
    """The last name of a kernel, without namespaces or template
    arguments: from an Itanium-mangled name (ptxas) or a demangled one
    (the profiler's trace)."""
    if name.startswith("_Z"):
        i = 3 if name.startswith("_ZN") else 2
        out = name
        while i < len(name) and name[i].isdigit():
            j = i
            while name[j].isdigit():
                j += 1
            n = int(name[i:j])
            out, i = name[j:j + n], j + n
        return out
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^(?:void|__global__)\s+", "", s.strip())
    s = s.split("(")[0].split("<")[0]
    return s.rsplit("::", 1)[-1].strip()


# ---------------------------------------------------------------------------
# probes (the only part that touches torch or the card)


@dataclass
class Probe:
    """One call of a wrapper's entry point: ``fn(device)`` builds its
    inputs from a seed (on the host, then moves them) and returns the
    outputs. ``bar``: ``"bits"`` or a tolerance of max |a - b| (a tail
    probe's bar against its plain version: the same call on CPU tensors,
    or ``plain(device)`` where the plain version is held on the card);
    ``valid`` masks the rows the bar reads; ``route()`` counts the
    launches of the route the probe must take; ``cluster`` the cluster
    size its plan launches."""

    name: str
    library: str
    kind: str                                   # "main" | "tail"
    fn: Callable[[Any], tuple]
    bar: Any = "bits"
    valid: Callable[[tuple], tuple] | None = None
    route: Callable[[], int] | None = None
    cluster: int = 1
    plain: Callable[[Any], tuple] | None = None


def _gen(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def _randn(shape, dtype, seed, dev, scale=1.0):
    import torch

    return (torch.randn(shape, generator=_gen(seed)) * scale).to(dtype).to(dev)


def _exact(shape, dtype, seed, dev):
    """Small multiples of 1/8 in [-2, 2]: every product and sum of a probe
    is exact in f32 in any order."""
    import torch

    return (torch.randint(-16, 17, shape, generator=_gen(seed)).float() / 8).to(dtype).to(dev)


def _probes() -> list[Probe]:
    import numpy as np
    import torch

    from crosscoder_tpu_torch.ops import adam, quant, sparse_grad
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    bf, f32 = torch.bfloat16, torch.float32
    out: list[Probe] = []

    def route(counter, key):
        return lambda: counter.by_route[key]

    # K1: the serve shape (Gemma-2-2B's 8 heads over 4 KV heads of 256, page
    # 64, softcap 50) on both routes; a tail of 96 rows (not a multiple of
    # the bf16 tile's 64 rows) at page 32 with ragged lengths
    def k1(D, S, page, lengths, dtype, seed):
        def fn(dev):
            q = _randn((D, S, 8, 256), dtype, seed, dev)
            k = _randn((D, S, 4, 256), dtype, seed + 1, dev)
            v = _randn((D, S, 4, 256), dtype, seed + 2, dev)
            lens = torch.tensor(lengths, dtype=torch.int32).to(dev)
            return (pa.paged_attention(q, k, v, lens, page_size=page, scale=256 ** -0.5,
                                       softcap=50.0),)
        return fn

    def k1_valid(lengths):
        return lambda outs: tuple(o[d, :n] for o in outs for d, n in enumerate(lengths))

    serve_lens = [1, 1024, 517, 64, 300, 999, 2, 800]
    tail_lens = [1, 95, 50]
    for dtype, key in ((bf, "tensor_cores"), (f32, "cuda_cores")):
        tag = "bf16" if dtype == bf else "f32"
        out.append(Probe(f"paged_attention/{tag}/main", "paged_attention", "main",
                         k1(8, 1024, 64, serve_lens, dtype, 10),
                         route=route(pa.paged_attention, key)))
        out.append(Probe(f"paged_attention/{tag}/tail", "paged_attention", "tail",
                         k1(3, 96, 32, tail_lens, dtype, 11), bar=K1_TOL[str(dtype)[6:]],
                         valid=k1_valid(tail_lens), route=route(pa.paged_attention, key)))

    # K2: the serve shape in bf16, the step lattice's fused-live shape in f32
    def k2(B, nd, width, k, dtype, exact):
        def fn(dev):
            mk = _exact if exact else _randn
            return tuple(fek.fused_topk_encode(mk((B, nd), dtype, 20, dev),
                                               mk((nd, width), dtype, 21, dev),
                                               mk((width,), f32, 22, dev), k))
        return fn

    out += [Probe("fused_topk/bf16/main", "fused_topk", "main", k2(8, 4608, 16384, 32, bf, False)),
            Probe("fused_topk/f32/main", "fused_topk", "main", k2(192, 256, 1024, 8, f32, False)),
            Probe("fused_topk/bf16/tail", "fused_topk", "tail", k2(13, 264, 1000, 7, bf, True)),
            Probe("fused_topk/f32/tail", "fused_topk", "tail", k2(13, 200, 1000, 7, f32, True))]

    # K3: leg I's training shape, block 256; a tail at block 64
    def k3(B, nd, width, k, block, exact):
        def fn(dev):
            mk = _exact if exact else _randn
            return tuple(fek.fused_topk_encode_q(mk((B, nd), bf, 30, dev),
                                                 mk((nd, width), bf, 31, dev),
                                                 mk((width,), f32, 32, dev), k, block))
        return fn

    out += [Probe("fused_topk_q/bf16/main", "fused_topk_q", "main",
                  k3(4096, 4608, 32768, 32, 256, False)),
            Probe("fused_topk_q/bf16/tail", "fused_topk_q", "tail",
                  k3(13, 320, 1000, 7, 64, True))]

    # K4: select + emit (the encode) and a count pass, leg K's shape in
    # bf16, the fused-live shape in f32
    def k4(B, nd, width, k, dtype, exact, hi):
        def fn(dev):
            mk = _exact if exact else _randn
            x, W, b = (mk((B, nd), dtype, 40, dev), mk((nd, width), dtype, 41, dev),
                       mk((width,), f32, 42, dev))
            return (fek.fused_batchtopk_encode(x, W, b, k),
                    fek.fused_batchtopk_count(x, W, b, 0, hi))
        return fn

    out += [Probe("fused_batchtopk/bf16/main", "fused_batchtopk", "main",
                  k4(4096, 4608, 32768, 32, bf, False, 1 << 15)),
            Probe("fused_batchtopk/f32/main", "fused_batchtopk", "main",
                  k4(192, 256, 1024, 8, f32, False, (1 << 31) - 1)),
            Probe("fused_batchtopk/bf16/tail", "fused_batchtopk", "tail",
                  k4(13, 264, 1000, 7, bf, True, 1 << 15)),
            Probe("fused_batchtopk/f32/tail", "fused_batchtopk", "tail",
                  k4(13, 272, 1000, 7, f32, True, (1 << 31) - 1))]

    # K5, K6: the TopK masks at legs A's and F's widths; tails 1003 wide
    def mask(fn_, R, W, k, dtype, seed):
        return lambda dev: (fn_(_randn((R, W), dtype, seed, dev), k),)

    out += [Probe("topk_mask/bf16/main", "topk_mask", "main",
                  mask(tp.topk_mask, 4096, 32768, 32, bf, 50)),
            Probe("topk_mask/bf16/tail", "topk_mask", "tail",
                  mask(tp.topk_mask, 13, 1003, 7, bf, 51)),
            Probe("topk_mask_f32/f32/main", "topk_mask_f32", "main",
                  mask(tp.topk_mask_f32, 4096, 16384, 32, f32, 52)),
            Probe("topk_mask_f32/f32/tail", "topk_mask_f32", "tail",
                  mask(tp.topk_mask_f32, 13, 1003, 7, f32, 53))]

    # K7: the cluster route at legs W's and V's widths, the streaming route
    # at its PERF.md row; tails whose widths cut no slice evenly
    for name, R, W, dtype, kind in (("cluster/bf16", 4096, 131072, bf, "main"),
                                    ("cluster/f32", 4096, 32768, f32, "main"),
                                    ("streaming/bf16", 512, 524288, bf, "main"),
                                    ("cluster/bf16", 5, 70001, bf, "tail"),
                                    ("cluster/f32", 5, 30001, f32, "tail"),
                                    ("streaming/bf16", 3, 600001, bf, "tail")):
        plan = tp.topk_plan(W, dtype)
        out.append(Probe(f"topk_chunked/{name}/{kind}", "topk_chunked", kind,
                         mask(tp.topk_chunked, R, W, 32 if kind == "main" else 7, dtype, 60),
                         route=route(tp.topk_chunked, plan[0]),
                         cluster=plan[1] if plan[0] == "cluster" else 1))

    # K8: the split route at leg A's width and k, the warp route past the
    # split route's k; tails
    def drain(R, W, k, dtype, seed):
        def fn(dev):
            f = tp.topk_plain(_randn((R, W), dtype, seed, "cpu"), max(k + 3, 40))
            return tuple(tp.sparsify(f.to(dev), k))
        return fn

    for name, R, W, k, dtype, kind in (("split/bf16", 4096, 32768, 32, bf, "main"),
                                       ("warp/bf16", 4096, 32768, 513, bf, "main"),
                                       ("split/bf16", 13, 70001, 7, bf, "tail"),
                                       ("warp/f32", 13, 1003, 7, f32, "tail")):
        out.append(Probe(f"sparsify/{name}/{kind}", "sparsify", kind, drain(R, W, k, dtype, 70),
                         route=route(tp.sparsify, tp.sparsify_plan(W, k, dtype)[0])))

    # K9: select + emit, bf16 at leg H's shape and f32; tails
    def k9(R, W, k, dtype, seed):
        def fn(dev):
            h = _randn((R, W), dtype, seed, dev)
            kth = tp.batchtopk_select(h, R * k)
            return kth, tp.batchtopk_emit(h, kth)
        return fn

    out += [Probe("batchtopk/bf16/main", "batchtopk", "main", k9(4096, 32768, 32, bf, 80)),
            Probe("batchtopk/f32/main", "batchtopk", "main", k9(4096, 16384, 32, f32, 81)),
            Probe("batchtopk/bf16/tail", "batchtopk", "tail", k9(13, 1003, 7, bf, 82)),
            Probe("batchtopk/f32/tail", "batchtopk", "tail", k9(13, 1003, 7, f32, 83))]

    # K10: the work list and the scatter, leg A's shape (4096 x 32 pairs onto
    # [32768, 4608]); a tail with a hot row (a third of the pairs on row 0)
    def k10(B, k, m, n_out, seed, hot):
        def fn(dev):
            idx = torch.randint(0, n_out, (B, k), generator=_gen(seed), dtype=torch.int32)
            if hot:
                idx[:, : k // 3] = 0
            return (sparse_grad.scatter_add_rows(_exact((B, k), f32, seed + 1, dev), idx.to(dev),
                                                 _exact((B, m), f32, seed + 2, dev), n_out),)
        return fn

    out += [Probe("scatter_rows/f32/main", "scatter_rows", "main",
                  k10(4096, 32, 4608, 32768, 90, False)),
            Probe("scatter_rows/f32/tail", "scatter_rows", "tail",
                  k10(13, 7, 301, 1001, 91, True))]

    # K11: the row route at leg Q's rows, the column route on W2.t() at leg
    # I's width; tails at block 8
    def k11_rows(R, d, block, dtype):
        return lambda dev: tuple(quant.quantize_rows(_randn((R, d), dtype, 100, dev), block))

    def k11_cols(d, R, block, dtype):
        return lambda dev: tuple(quant.quantize_rows(_randn((d, R), dtype, 101, dev).t(), block))

    out += [Probe("quantize_rows/row/main", "quantize_rows", "main",
                  k11_rows(8184, 2304, 256, bf), route=route(quant.quantize_rows, "row")),
            Probe("quantize_rows/column/main", "quantize_rows", "main",
                  k11_cols(4608, 32768, 256, bf), route=route(quant.quantize_rows, "column")),
            Probe("quantize_rows/row/tail", "quantize_rows", "tail",
                  k11_rows(13, 264, 8, f32), route=route(quant.quantize_rows, "row")),
            Probe("quantize_rows/column/tail", "quantize_rows", "tail",
                  k11_cols(264, 1001, 8, bf), route=route(quant.quantize_rows, "column"))]

    # O1: leg A's four f32 leaves in one launch; a tail of odd leaves, one bf16
    def o1(shapes, seed, update=adam.adam_update):
        def fn(dev):
            leaves = [{n: _randn(s, dt, seed + 7 * i + j, dev, scale=sc)
                       for j, (n, (s, dt)) in enumerate(sorted(shapes.items()))}
                      for i, sc in enumerate((0.1, 1.0, 0.01, 0.01))]
            params, grads, mu, nu = leaves
            nu = {n: t.abs() for n, t in nu.items()}
            f32c = lambda x: float(np.float32(x))  # noqa: E731 — the optimizer's f32 coefficients
            update(params, grads, mu, nu, torch.tensor(2.0).to(dev), max_norm=1.0, b1=0.9,
                   b2=0.999, eps=1e-8, bc1=f32c(1 - 0.9 ** 3), bc2=f32c(1 - 0.999 ** 3),
                   step_size=f32c(-1e-3))
            return tuple(t for d in (params, mu, nu) for _, t in sorted(d.items()))
        return fn

    # (its bf16 leaf is held to the plain update on the card, as chip_smoke.py
    # holds O1: PyTorch's CPU ops round bf16 at other places than its CUDA ops)
    tail = {"a": ((13, 1001), f32), "b": ((7,), f32), "c": ((5, 3), bf)}
    out += [Probe("adam_update/f32/main", "adam_update", "main", o1(
                {"W_enc": ((2, 2304, 32768), f32), "W_dec": ((32768, 2, 2304), f32),
                 "b_enc": ((32768,), f32), "b_dec": ((2, 2304), f32)}, 110)),
            Probe("adam_update/mixed/tail", "adam_update", "tail", o1(tail, 111),
                  plain=o1(tail, 111, adam.adam_update_plain))]
    return out


def tail_probes() -> list[Probe]:
    return [p for p in _probes() if p.kind == "tail"]


def _host(outs) -> tuple:
    return tuple(o.detach().cpu() for o in outs)


def _bits(t):
    import torch

    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bool else t.reshape(-1).view(torch.uint8)


def same_bits(a: tuple, b: tuple) -> bool:
    import torch

    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def meets_bar(probe: Probe, got: tuple, want: tuple) -> tuple[bool, str]:
    """``(ok, detail)``: ``got`` (the card's) against ``want`` (the plain
    version's) at the probe's bar."""
    if probe.valid is not None:
        got, want = probe.valid(got), probe.valid(want)
    if probe.bar == "bits":
        ok = same_bits(got, want)
        return ok, "bitwise" if ok else "not bitwise"
    err = max((float((g.float() - w.float()).abs().max()) if g.numel() else 0.0)
              for g, w in zip(got, want))
    return err <= probe.bar, f"max |err| {err:.3g} (bar {probe.bar:g})"


def device_limits(dev) -> DeviceLimits:
    import torch

    p = torch.cuda.get_device_properties(dev)
    return DeviceLimits(
        max_threads_per_block=int(p.max_threads_per_block),
        smem_per_block_optin=int(p.shared_memory_per_block_optin),
        smem_per_sm=int(p.shared_memory_per_multiprocessor),
        regs_per_sm=int(p.regs_per_multiprocessor),
        max_threads_per_sm=int(p.max_threads_per_multi_processor))


def ptxas_reports(names) -> dict[str, dict[str, dict[str, int]]]:
    """:func:`ptxas_report` of every library, the ``nvcc`` runs it needs
    all at once."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(ptxas_report, names)))


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """ptxas's per-function report of library ``name`` by base name: from
    the compile tier's record of this process's build or its sidecar, else
    from an ``nvcc`` run of its own into a scratch directory."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.utils import compile_cache

    cost = _build.library_cost(name)
    if cost is None or not cost.get("entries"):
        with tempfile.TemporaryDirectory(prefix="contracts_ptxas_") as td:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{td}/{name}.so",
                   str(_build.CSRC / f"{name}.cu")]
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if r.returncode:
                raise _build.KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{r.stdout}"
                                              f"{r.stderr}")
            cost = {"entries": compile_cache.parse_ptxas(r.stdout + r.stderr)}
    out: dict[str, dict[str, int]] = {}
    for fn, e in cost["entries"].items():
        if "registers" not in e:
            continue                          # a device function's stack report only
        cur = out.setdefault(base_name(fn), {"registers": 0, "smem_bytes": 0,
                                             "spill_stores": 0, "spill_loads": 0})
        for key in cur:
            cur[key] = max(cur[key], int(e.get(key, 0)))
    return out


def _trace_launches(trace: dict, globals_: dict[str, set[str]], probes: dict[str, Probe]
                    ) -> list[CapturedLaunch]:
    """Every launch of one of the port's kernels (a base name some
    library's ptxas report holds) in a chrome trace, each attributed to the
    probe (a ``probe:<name>`` annotation) that issued it: through its
    launch call's correlation id, else through the GPU-side annotation
    around it. A kernel several libraries hold (a header's) is the
    probe's library's where that library holds it."""
    events = trace.get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"][6:], e.get("cat", ""))
                   for e in events if str(e.get("name", "")).startswith("probe:")
                   and "ts" in e)
    calls = {e["args"]["correlation"]: e["ts"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in
             e.get("args", {})}

    def probe_at(ts: float, gpu: bool) -> str:
        best = ""
        for t0, t1, name, cat in spans:
            if t0 <= ts <= t1 and (cat == "gpu_user_annotation") == gpu:
                best = name
        return best

    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kernel = base_name(e["name"])
        libs = [lib for lib, g in sorted(globals_.items()) if kernel in g]
        if not libs:
            continue                          # torch's own kernel
        a = e.get("args", {})
        corr = a.get("correlation")
        probe = (probe_at(calls[corr], False) if corr in calls else "") \
            or probe_at(e["ts"], True)
        p = probes.get(probe)
        occ = a.get("est. achieved occupancy %")
        out.append(CapturedLaunch(
            library=p.library if p is not None and p.library in libs else libs[0],
            kernel=kernel, probe=probe,
            grid=tuple(int(x) for x in a.get("grid", (0, 0, 0))),
            block=tuple(int(x) for x in a.get("block", (0, 0, 0))),
            registers=int(a.get("registers per thread", 0)),
            smem_bytes=int(a.get("shared memory", 0)),
            occupancy=None if occ is None else float(occ),
            cluster=p.cluster if p is not None else 1))
    return out


def sanitizer_path() -> str | None:
    """``compute-sanitizer`` beside ``nvcc`` (or on ``PATH``), else ``None``."""
    from crosscoder_tpu_torch.ops import _build

    try:
        bin_dir = Path(_build._nvcc()).parent
    except _build.KernelBuildError:
        return shutil.which("compute-sanitizer")
    for cand in (bin_dir / "compute-sanitizer", bin_dir.parent / "compute-sanitizer"
                 / "compute-sanitizer"):
        if cand.is_file():
            return str(cand)
    return shutil.which("compute-sanitizer")


_CONTROL = ("import torch; x = torch.ones(1, device='cuda'); x.add_(1); "
            "torch.cuda.synchronize()")


def sanitizer_usable(tool: str) -> tuple[bool, str]:
    """``(usable, why not)``: whether ``compute-sanitizer --tool <tool>``
    runs a minimal CUDA program (one allocation, one kernel) cleanly on
    this machine. A tool that fails there cannot judge the kernels."""
    exe = sanitizer_path()
    if exe is None:
        return False, "compute-sanitizer is not installed beside nvcc"
    root, env = _child_env()
    r = subprocess.run([exe, "--tool", tool, "--error-exitcode", "99", sys.executable, "-c",
                        _CONTROL], capture_output=True, text=True, cwd=str(root), env=env,
                       timeout=300)
    if r.returncode == 0:
        return True, ""
    lines = [ln.strip("= ").strip() for ln in (r.stdout + r.stderr).splitlines()
             if "Error" in ln or "error" in ln]
    return False, (f"compute-sanitizer --tool {tool} fails on a minimal CUDA program "
                   f"here (exit {r.returncode}): {' | '.join(lines[:3])}"[:400])


_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) error")
_HAZARDS = re.compile(r"RACECHECK SUMMARY: (\d+) hazard")


def run_sanitizer(tool: str) -> dict[str, Any] | None:
    """``compute-sanitizer --tool <tool>`` over the tail probes in a child
    process with ``PYTORCH_NO_CUDA_MEMORY_CACHING=1``: ``{"errors": n,
    "rc": code, "seconds": s, "text": the report's tail}``, or ``None``
    where the tool is not installed."""
    import time

    exe = sanitizer_path()
    if exe is None:
        return None
    root, env = _child_env()
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    cmd = [exe, "--tool", tool, "--error-exitcode", "99", sys.executable, "-m", _MODULE,
           "--tail-probes"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=str(root), env=env,
                       timeout=CHILD_TIMEOUT_S)
    text = r.stdout + r.stderr
    m = _SUMMARY.search(text) or _HAZARDS.search(text)
    errors = int(m.group(1)) if m else (0 if r.returncode == 0 else -1)
    return {"errors": errors, "rc": r.returncode, "seconds": time.perf_counter() - t0,
            "text": text[-3000:]}


def capture(dev, globals_: dict[str, set[str]]) -> dict[str, Any]:
    """Run every probe once on the card under ``torch.profiler`` and
    capture its launches, then run each tail probe twice more and once
    through its plain version on the CPU: ``{"launches", "probe_errors",
    "tail_bars", "repeats"}`` as JSON-ready data."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    probes = _probes()
    errors: dict[str, str] = {}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p in probes:
            try:
                before = p.route() if p.route else 0
                with record_function(f"probe:{p.name}"):
                    p.fn(dev)
                    torch.cuda.synchronize(dev)
                if p.route and p.route() == before:
                    errors[p.name] = "the probe did not take its route"
            except Exception as e:  # noqa: BLE001 — a probe that raises is a finding
                errors[p.name] = f"{type(e).__name__}: {e}"[:500]
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="contracts_trace_") as td:
        path = f"{td}/trace.json"
        prof.export_chrome_trace(path)
        trace = json.loads(Path(path).read_text())
    launches = _trace_launches(trace, globals_, {p.name: p for p in probes})
    bars, repeats = {}, {}
    for p in probes:
        if p.kind != "tail" or p.name in errors:
            continue
        try:
            a, b = _host(p.fn(dev)), _host(p.fn(dev))
            repeats[p.name] = same_bits(a, b)
            ref = p.plain(dev) if p.plain else p.fn(torch.device("cpu"))
            bars[p.name] = meets_bar(p, a, _host(ref))
        except Exception as e:  # noqa: BLE001
            errors[p.name] = f"{type(e).__name__}: {e}"[:500]
    return {"launches": [dataclasses.asdict(ln) for ln in launches], "probe_errors": errors,
            "tail_bars": bars, "repeats": repeats}


def _child_env() -> tuple[Path, dict[str, str]]:
    root = Path(__file__).resolve().parents[3]
    return root, dict(os.environ, PYTHONPATH=str(root) + os.pathsep
                      + os.environ.get("PYTHONPATH", ""))


def _capture_in_child(globals_: dict[str, set[str]]) -> dict[str, Any]:
    """:func:`capture` in a fresh process: the probes' profiler session is
    then the first of its process, whatever profiling the caller did."""
    root, env = _child_env()
    with tempfile.TemporaryDirectory(prefix="contracts_capture_") as td:
        src, out = Path(td) / "globals.json", Path(td) / "capture.json"
        src.write_text(json.dumps({k: sorted(v) for k, v in globals_.items()}))
        r = subprocess.run([sys.executable, "-m", _MODULE, "--capture", str(src), str(out)],
                           capture_output=True, text=True, cwd=str(root), env=env,
                           timeout=CHILD_TIMEOUT_S)
        if r.returncode or not out.is_file():
            raise RuntimeError(f"the capture process failed (exit {r.returncode}): "
                               f"{(r.stdout + r.stderr)[-3000:]}")
        got = json.loads(out.read_text())
    got["launches"] = [CapturedLaunch(**{**d, "grid": tuple(d["grid"]),
                                         "block": tuple(d["block"])})
                       for d in got["launches"]]
    got["tail_bars"] = {k: tuple(v) for k, v in got["tail_bars"].items()}
    return got


def run_kernel_probes(device=None, sanitize: bool = True) -> KernelContext:
    """Build every library and read its ptxas report and the card's limits
    here; capture every probe's launches and check the tail probes in a
    fresh process (:func:`capture`); with ``sanitize``, run the two
    sanitizers over the tail probes. On the CPU the context stays empty and
    every kernel rule is skipped. Runs on ``cuda`` unless ``device`` names
    another device."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    ctx = KernelContext(libraries=_build.kernel_names())
    if dev.type != "cuda":
        ctx.skip_reasons = {r.name: CPU_REASON for r in KERNEL_RULES}
        return ctx
    _build.build_all()
    ctx.limits = device_limits(dev)
    ctx.ptxas = ptxas_reports(ctx.libraries)
    ctx.globals = {name: set(ctx.ptxas[name]) for name in ctx.libraries}
    got = _capture_in_child(ctx.globals)
    ctx.launches, ctx.probe_errors = got["launches"], got["probe_errors"]
    ctx.tail_bars, ctx.repeats = got["tail_bars"], got["repeats"]
    for tool in SANITIZER_TOOLS:
        if not sanitize:
            ctx.skip_reasons[SANITIZER_RULES[tool]] = "the sanitizers were not asked for"
            continue
        usable, why = sanitizer_usable(tool)
        if usable:
            ctx.sanitizer[tool] = run_sanitizer(tool)
        else:
            ctx.skip_reasons[SANITIZER_RULES[tool]] = f"{why}; {tail_summary(ctx)}"
    return ctx


# ---------------------------------------------------------------------------
# rules (pure functions of KernelContext)


def _is_kernel_ctx(ctx: Any) -> bool:
    return isinstance(ctx, KernelContext) and bool(ctx.launches)


def _ran(tool: str):
    return lambda ctx: _is_kernel_ctx(ctx) and ctx.sanitizer.get(tool) is not None


def _check_coverage(ctx: KernelContext) -> list[Finding]:
    out = []
    for probe, err in sorted(ctx.probe_errors.items()):
        out.append(Finding(rule="kernel-probe-coverage", location=probe,
                           message=f"probe failed: {err}"))
    launched = {ln.kernel for ln in ctx.launches}
    probed = {ln.library for ln in ctx.launches}
    for lib in ctx.libraries:
        if lib not in probed:
            out.append(Finding(
                rule="kernel-probe-coverage", location=lib,
                message="no probe launched a kernel of this library — its "
                        "wrapper's path was not exercised"))
        for k in sorted(ctx.globals.get(lib, ()) - launched):
            out.append(Finding(
                rule="kernel-probe-coverage", location=f"{lib}/{k}",
                message=f"__global__ {k} of csrc/{lib}.cu was launched by no "
                        f"probe (a route no probe takes)"))
    return out


def _check_limits(ctx: KernelContext) -> list[Finding]:
    out = []
    lim = ctx.limits
    for ln in ctx.launches:
        loc = f"{ln.library}/{ln.kernel} ({ln.probe})"
        if ln.threads > lim.max_threads_per_block or any(
                b > m for b, m in zip(ln.block, lim.max_block)) or min(ln.block) < 1:
            out.append(Finding(
                rule="kernel-launch-limits", location=loc,
                message=f"block {ln.block} ({ln.threads} threads) outside the "
                        f"device's {lim.max_threads_per_block} threads and "
                        f"{lim.max_block} dimensions"))
        if any(g > m for g, m in zip(ln.grid, lim.max_grid)) or min(ln.grid) < 1:
            out.append(Finding(
                rule="kernel-launch-limits", location=loc,
                message=f"grid {ln.grid} outside the device's {lim.max_grid}"))
    return out


def _check_smem(ctx: KernelContext) -> list[Finding]:
    out = []
    lim = ctx.limits
    for ln in ctx.launches:
        loc = f"{ln.library}/{ln.kernel} ({ln.probe})"
        if ln.smem_bytes > lim.smem_per_block_optin:
            out.append(Finding(
                rule="kernel-smem-budget", location=loc,
                message=f"{ln.smem_bytes} B of shared memory a block, over the "
                        f"device's {lim.smem_per_block_optin} B opt-in limit"))
        regs = ln.registers * ln.threads
        if regs > lim.regs_per_sm:
            out.append(Finding(
                rule="kernel-smem-budget", location=loc,
                message=f"{ln.registers} registers x {ln.threads} threads = {regs} "
                        f"a block, over the SM's {lim.regs_per_sm}: no block fits"))
    return out


def _sanitizer_findings(ctx: KernelContext, tool: str, rule: str) -> list[Finding]:
    got = ctx.sanitizer.get(tool)
    if got is None or (got["errors"] == 0 and got["rc"] == 0):
        return []
    return [Finding(rule=rule, location=f"compute-sanitizer --tool {tool}",
                    message=f"{got['errors']} errors over the tail probes (exit "
                            f"{got['rc']}): {got['text'][-1500:]}")]


def _check_tail_oob(ctx: KernelContext) -> list[Finding]:
    out = _sanitizer_findings(ctx, "memcheck", "kernel-tail-oob")
    for probe, (ok, detail) in sorted(ctx.tail_bars.items()):
        if not ok:
            out.append(Finding(rule="kernel-tail-oob", location=probe,
                               message=f"the tail probe misses its bar against the "
                                       f"plain version: {detail}"))
    return out


def _check_races(ctx: KernelContext) -> list[Finding]:
    out = _sanitizer_findings(ctx, "racecheck", "kernel-write-race")
    for probe, same in sorted(ctx.repeats.items()):
        if not same:
            out.append(Finding(rule="kernel-write-race", location=probe,
                               message="the tail probe's two runs differ bitwise "
                                       "(an order-dependent write)"))
    return out


def _check_local_memory(ctx: KernelContext) -> list[Finding]:
    out = []
    for lib in sorted(ctx.ptxas):
        for k, e in sorted(ctx.ptxas[lib].items()):
            if e.get("spill_stores", 0) or e.get("spill_loads", 0):
                out.append(Finding(
                    rule="kernel-local-memory", location=f"{lib}/{k}", severity="warning",
                    message=f"ptxas spills {e['spill_stores']} B stored / "
                            f"{e['spill_loads']} B loaded to local memory "
                            f"({e['registers']} registers)"))
    return out


KERNEL_RULES: list[Rule] = [
    Rule("kernel-probe-coverage",
         "every library probed and every __global__ launched by a probe",
         _is_kernel_ctx, _check_coverage),
    Rule("kernel-launch-limits",
         "threads per block and grid dimensions within the device's limits",
         _is_kernel_ctx, _check_limits),
    Rule("kernel-smem-budget",
         "shared memory and registers x threads of a block fit one SM",
         _is_kernel_ctx, _check_smem),
    Rule("kernel-tail-oob",
         "memcheck clean over the tail probes; each meets its plain bar",
         _ran("memcheck"), _check_tail_oob),
    Rule("kernel-write-race",
         "racecheck clean; each tail probe bitwise the same twice",
         _ran("racecheck"), _check_races),
    Rule("kernel-local-memory",
         "no kernel spills registers to local memory (warning)",
         _is_kernel_ctx, _check_local_memory),
]


def tail_failures(ctx: KernelContext) -> list[str]:
    """The tail probes that missed their bar or differed between two runs."""
    return sorted({p for p, (ok, _) in ctx.tail_bars.items() if not ok}
                  | {p for p, same in ctx.repeats.items() if not same})


def tail_summary(ctx: KernelContext) -> str:
    """The tail probes' verdicts in a line (they stand whether or not a
    sanitizer runs)."""
    n = len(ctx.tail_bars)
    ok = sum(v for v, _ in ctx.tail_bars.values())
    return (f"the tail probes: {ok} of {n} at their bars against the plain versions, "
            f"{sum(ctx.repeats.values())} of {len(ctx.repeats)} bitwise twice"
            + (f" (failing: {', '.join(tail_failures(ctx))})" if tail_failures(ctx) else ""))


def occupancy(ln: CapturedLaunch, lim: DeviceLimits) -> float:
    """Theoretical occupancy of a launch: resident threads an SM over its
    maximum, from its threads, registers and shared memory."""
    t = max(1, ln.threads)
    warps = -(-t // 32)
    by_threads = lim.max_threads_per_sm // (warps * 32)
    by_regs = lim.regs_per_sm // max(1, -(-ln.registers * 32 // 256) * 256 * warps) \
        if ln.registers else by_threads
    by_smem = lim.smem_per_sm // ln.smem_bytes if ln.smem_bytes else by_threads
    blocks = max(0, min(by_threads, by_regs, by_smem, 32))
    return blocks * warps * 32 / lim.max_threads_per_sm


def launch_table(ctx: KernelContext) -> list[dict[str, Any]]:
    """One row a (library, kernel, probe): grid, block, registers, shared
    memory, theoretical occupancy and the trace's estimate."""
    rows, seen = [], set()
    for ln in ctx.launches:
        key = (ln.library, ln.kernel, ln.probe, ln.grid, ln.block)
        if key in seen:
            continue
        seen.add(key)
        rows.append({"library": ln.library, "kernel": ln.kernel, "probe": ln.probe,
                     "grid": list(ln.grid), "block": list(ln.block),
                     "registers": ln.registers, "smem": ln.smem_bytes,
                     "cluster": ln.cluster, "occupancy": round(occupancy(ln, ctx.limits), 4),
                     "est_occupancy_pct": ln.occupancy})
    return rows


def smem_summary(ctx: KernelContext) -> dict[str, str]:
    """Per-library shared-memory peak for ``Report.info`` (JAX's
    ``vmem_summary``)."""
    out = {}
    for lib in ctx.libraries:
        lns = [ln for ln in ctx.launches if ln.library == lib]
        if not lns:
            out[f"smem/{lib}"] = "no launch captured"
            continue
        top = max(lns, key=lambda ln: ln.smem_bytes)
        out[f"smem/{lib}"] = (f"{top.smem_bytes / 1024:.1f} KiB peak ({top.kernel}) of "
                              f"{ctx.limits.smem_per_block_optin / 1024:.0f} KiB opt-in; "
                              f"most registers {max(ln.registers for ln in lns)}")
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="the kernel probes' child processes")
    ap.add_argument("--tail-probes", action="store_true",
                    help="run the tail probes once each on the card (the sanitizers' child)")
    ap.add_argument("--capture", nargs=2, metavar=("GLOBALS_JSON", "OUT_JSON"),
                    help="capture every probe's launches and check the tail probes")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    if args.capture:
        globals_ = {k: set(v) for k, v in json.loads(Path(args.capture[0]).read_text()).items()}
        Path(args.capture[1]).write_text(json.dumps(capture(dev, globals_)))
        return 0
    if not args.tail_probes:
        ap.error("give --tail-probes or --capture")
    for p in tail_probes():
        p.fn(dev)
        torch.cuda.synchronize(dev)
    print(f"tail probes: {len(tail_probes())} ran", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

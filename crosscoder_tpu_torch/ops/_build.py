"""Build and load the hand-written Hopper kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`. Libraries land in
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the headers it may include (``csrc/*.cuh``) and the compiler
flags, so an edited source or header rebuilds and an unchanged one loads
at once. Nothing here runs at import: a kernel is
built the first time its wrapper launches it, or ahead of traffic by
:func:`build_all`, which starts one ``nvcc`` per source at once.

A build failure raises :class:`KernelBuildError` with the compiler's
output; nothing catches it. Every C entry point returns
``cudaGetLastError()`` after its launch and :func:`check` raises on a
nonzero code, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.

Every wrapper gives :func:`load` its entry points' prototypes, set once
when the library loads, and passes :func:`stream`; a library swapped into
``_libs`` by hand takes them through :func:`set_prototypes`.

With the compile tier on (``cfg.compile_cache_dir``, configured by the
Trainer, the serve engine, the fleet and the tuner;
:mod:`crosscoder_tpu_torch.utils.compile_cache`), :func:`load` and
:func:`build_all` ask the tier for each library instead: a hit loads the
tier's file, a miss claims the entry, runs ``nvcc`` into the tier and
places the library there, and a process that loses the claim waits for the
leader's entry. :func:`build_all` acquires every source on a thread of its
own, so every source is claimed at once and the ``nvcc`` runs and the waits
overlap. A corrupt, stale or tampered entry is built anew by ``nvcc``; a
failed build, or a fresh library that does not load, raises
:class:`KernelBuildError`. With the tier off (the default) nothing of it
runs. A library loaded before the tier is configured stays loaded.

Each acquisition runs under a ``compile`` span (``source=disk|build``) and
each ``nvcc`` run is counted in :data:`nvcc_runs` and reported to the
telemetry plane (:func:`crosscoder_tpu_torch.utils.compile_cache.report_compile`).
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.utils import compile_cache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# the nvcc runs this process finished, by source: the serve engine's compile
# accounting and the warm-start probe read them
nvcc_runs: collections.Counter = collections.Counter()
_runs_lock = threading.Lock()
_nvcc_versions: dict[str, str] = {}
_version_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` failed or is missing; the message carries its output."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error code."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"nvcc not found under {home}/bin or on PATH: the CUDA kernels "
            f"of crosscoder_tpu_torch need the CUDA toolkit"
        )
    return found


def nvcc_version() -> str:
    """The release and build lines of ``nvcc --version`` (``"none"``
    without a toolkit): part of the compile tier's fingerprint."""
    try:
        path = _nvcc()
    except KernelBuildError:
        return "none"
    with _version_lock:
        got = _nvcc_versions.get(path)
        if got is None:
            out = subprocess.run([path, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [ln.strip() for ln in out.splitlines()
                     if "release" in ln or ln.startswith("Build")]
            got = _nvcc_versions[path] = (" ".join(lines)
                                          or hashlib.sha256(out.encode()).hexdigest()[:16])
    return got


def header_paths() -> list[Path]:
    """Every ``csrc/*.cuh``, in the order the library hash reads them."""
    return sorted(CSRC.glob("*.cuh"))


def library_hash(source: bytes, headers: Sequence[bytes], flags: Sequence[str]) -> str:
    """sha256 of a library's inputs besides the toolchain: its ``.cu``
    source, the headers it may include (in :func:`header_paths` order) and
    the ``nvcc`` flags. Pure: the compile tier's key rule
    (``cache-key-completeness``) perturbs each input through it."""
    return hashlib.sha256(source + b"".join(headers) + " ".join(flags).encode()).hexdigest()


def source_hash(name: str) -> str:
    """:func:`library_hash` of ``csrc/<name>.cu``, every ``csrc/*.cuh`` and
    :data:`NVCC_FLAGS`: what the library depends on besides the toolchain."""
    return library_hash((CSRC / f"{name}.cu").read_bytes(),
                        [p.read_bytes() for p in header_paths()], NVCC_FLAGS)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(name)[:16]}.so"


def _key(name: str) -> tuple[str, str]:
    """The compile tier's key of a library (its label first)."""
    return (name, source_hash(name))


def _spawn(name: str, tmp: Path) -> tuple[subprocess.Popen, float]:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter()


def _wait(name: str, proc: subprocess.Popen, tmp: Path, t0: float) -> str:
    """One ``nvcc`` run to its end: counted and reported when it built,
    :class:`KernelBuildError` when it failed."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    with _runs_lock:
        nvcc_runs[name] += 1
    compile_cache.report_compile(name, time.perf_counter() - t0)
    return log


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc, t0 = _spawn(name, tmp)
    return proc, tmp, out, t0


def _finish(name: str, started: tuple[subprocess.Popen, Path, Path, float]) -> str:
    proc, tmp, out, t0 = started
    log = _wait(name, proc, tmp, t0)
    os.replace(tmp, out)
    compile_cache.record_cost(_key(name), compile_cache.Built(out, log))
    return log


def compiles() -> int:
    """The ``nvcc`` runs this process finished."""
    with _runs_lock:
        return sum(nvcc_runs.values())


def _build_scratch(name: str, logs: dict[str, str] | None) -> compile_cache.Built:
    """``nvcc`` into a scratch file of the tier's directory, loaded once
    to prove that it loads."""
    tmp = compile_cache.disk_cache().scratch_path(name)
    proc, t0 = _spawn(name, tmp)
    log = _wait(name, proc, tmp, t0)
    try:
        handle = ctypes.CDLL(str(tmp))
    except OSError as e:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"csrc/{name}.cu built, but its library does not load: "
                               f"{e}") from e
    if logs is not None:
        logs[name] = log
    return compile_cache.Built(tmp, log, handle)


def _acquire_tiered(name: str, logs: dict[str, str] | None = None) -> ctypes.CDLL:
    return compile_cache.aot_get(
        _key(name), lambda: _build_scratch(name, logs), lower=lambda: source_hash(name),
        span=lambda src: trace.span("compile", variant=name, source=src))


def _acquire(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``: from the compile tier when
    it is on, else from ``build/kernels/``, built there first if absent."""
    if compile_cache.disk_enabled():
        return _acquire_tiered(name)
    s = _start(name)
    with trace.span("compile", variant=name, source="disk" if s is None else "build"):
        if s is not None:
            _finish(name, s)
        return ctypes.CDLL(str(_lib_path(name)))


def library_cost(name: str) -> dict | None:
    """ptxas's report of ``name``'s library, where this process built it
    or the compile tier's sidecar holds it (no ``nvcc`` run)."""
    return compile_cache.cost_of(_key(name))


def kernel_names() -> tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source,
    all started together. Returns ``{name: compiler output}`` for the
    sources built now (``-Xptxas -v`` register and shared-memory report).
    With the compile tier on, every library not loaded yet is acquired
    through it, one thread a source, and loaded."""
    with _lock:
        if compile_cache.disk_enabled():
            names = [n for n in kernel_names() if n not in _libs]
            logs: dict[str, str] = {}
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(1, len(names)), thread_name_prefix="kernel-build") as pool:
                futures = [pool.submit(_acquire_tiered, n, logs) for n in names]
            for f in futures:
                f.result()
            return dict(sorted(logs.items()))
        started = {n: _start(n) for n in kernel_names()}
        logs = {}
        try:
            for n, s in started.items():
                if s is not None:
                    logs[n] = _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        return logs


def set_prototypes(lib: ctypes.CDLL, prototypes: dict[str, list]) -> ctypes.CDLL:
    """Give each entry point ``{name: argtypes}`` of ``lib`` its argument
    types and an ``int`` result, once, so that a call pays no setup."""
    for fn_name, argtypes in prototypes.items():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def load(name: str, prototypes: dict[str, list] | None = None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use; its
    entry points get ``prototypes`` (:func:`set_prototypes`) when it loads."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = set_prototypes(_acquire(name), prototypes or {})
            _libs[name] = lib
        return lib


def stream(device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (a
    ``torch.device`` with an index), without building a ``Stream`` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelLaunchError(f"{what}: CUDA error {code}")

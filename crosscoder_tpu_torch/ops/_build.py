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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def kernel_names() -> tuple[str, ...]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built, one ``nvcc`` per source,
    all started together. Returns ``{name: compiler output}`` for the
    sources built now (``-Xptxas -v`` register and shared-memory report)."""
    with _lock:
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
            s = _start(name)
            if s is not None:
                _finish(name, s)
            lib = set_prototypes(ctypes.CDLL(str(_lib_path(name))), prototypes or {})
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

"""The persistent compile tier of the port's kernel libraries, ported from
:mod:`crosscoder_tpu.utils.compile_cache`.

PyTorch runs every step eagerly, so the one thing the port compiles is its
hand-written kernels: each ``csrc/<name>.cu`` becomes a shared library
through ``nvcc`` (:mod:`crosscoder_tpu_torch.ops._build`). The JAX tier's
executables map onto those libraries and onto nothing else: no step, serve
bucket or scan is compiled here.

Two layers, as in the JAX package:

- ``ops/_build.py`` names each library in ``build/kernels/`` by a hash of
  its source, every header and the flags, and loads an existing file
  without ``nvcc``. That directory is always on, the counterpart of JAX's
  ``enable()``, which has no function here.
- The **disk tier** (``cfg.compile_cache_dir``; ``$CROSSCODER_COMPILE_CACHE_DIR``
  as the tooling fallback) adds what JAX's AOT tier adds: the toolchain and
  the card in every key and entry (:func:`backend_fingerprint`), one
  ``nvcc`` a library across processes (the claim), a byte cap with LRU
  eviction, a corrupt, stale or tampered entry rebuilt by ``nvcc`` (never
  served from a plain op), a strict verify, hit/miss/eviction counters
  through the registry, and ``ptxas``'s report in a cost sidecar. Off by
  default (``compile_cache_dir=""``): ``_build`` then never comes here, and
  its paths and libraries are what they are without the tier.

An entry is a library that only ever appears by an atomic rename and only
ever goes by ``unlink``: a process that mapped a ``.so`` gets SIGBUS if the
file is truncated under it, and an unlinked or replaced file stays mapped.
``dlopen`` caches by path, so a process loads each library once (the memo
here, ``_build._libs`` above it); a library loaded before :func:`configure`
stays loaded.

Compile events: ``_build`` reports each ``nvcc`` run through
:func:`report_compile` to every :class:`~crosscoder_tpu_torch.obs.Observability`
alive (``perf/compiles``, ``perf/compile_s``) and runs each library's
acquisition under a ``compile`` span with ``source=disk|build``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import re
import sys
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable

DISK_FORMAT = 1

# one process compiles, peers load: a loser of the claim race waits at most
# this long for the leader's entry before building live anyway
_CLAIM_WAIT_S = float(os.environ.get("CROSSCODER_COMPILE_CACHE_WAIT_S", "120"))
# a claim older than this is a dead leader's; stealable
_CLAIM_TTL_S = float(os.environ.get("CROSSCODER_COMPILE_CACHE_CLAIM_TTL_S", "600"))


def variant_key(metrics: bool, aux: bool, refresh: bool, *,
                enc: str = "dense", tenant: str = "") -> str:
    """Canonical label of one train-step variant, byte for byte the JAX
    package's: ``(metrics, aux, refresh)`` is the Trainer's variant tuple,
    ``enc`` the encoder tier ("dense", "fused", "fused-int8"), ``tenant``
    the fleet's bucket tag (``""`` for a solo trainer)."""
    tag = f", tenant={tenant}" if tenant else ""
    return (f"train_step(metrics={metrics}, aux={aux}, "
            f"refresh={refresh}, enc={enc}{tag})")


@dataclasses.dataclass
class Built:
    """A library ``nvcc`` just wrote: ``path`` (a scratch file the tier
    takes over by rename), the compiler's output, and the library once
    loaded from ``path`` (``None`` until then)."""

    path: Path
    log: str = ""
    handle: Any = None


# ---------------------------------------------------------------------------
# in-memory memo: bounded LRU + lock


# guards every module-level table below
_LOCK = threading.RLock()

# in-flight builds: key → _Inflight; concurrent same-key callers get exactly
# one build
_INFLIGHT: dict[Any, "_Inflight"] = {}

# bounded LRU of loaded libraries (insertion order = recency; hits
# move_to_end). 256 is JAX's bound; the port has 12 libraries
_AOT_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_AOT_CACHE_CAP = 256

# key → ptxas report of every library that passed through here; it
# outlives the memo's eviction
_COST_CACHE: dict[Any, dict[str, Any]] = {}

# Observability planes alive in this process: each nvcc run is reported to them
_OBSERVERS: list[Any] = []


class _Inflight:
    """One in-progress build: the owner resolves, waiters block on it."""

    __slots__ = ("event", "value", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: BaseException | None = None

    def wait(self) -> Any:
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.value


def _evict_memo_locked() -> None:
    """Drop least-recently-used entries past the cap (_LOCK held). ctypes
    never unloads a library, so a dropped one stays mapped, and its cost
    stays in ``_COST_CACHE``."""
    while len(_AOT_CACHE) > _AOT_CACHE_CAP:
        _AOT_CACHE.popitem(last=False)


# ---------------------------------------------------------------------------
# the cost of a library: ptxas's report

_PTX_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([^'\s]+)'?")
_PTX_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads")
_PTX_USED = re.compile(r"Used (\d+) registers")
_PTX_SMEM = re.compile(r"(\d+) bytes smem")
_PTX_BARRIERS = re.compile(r"used (\d+) barriers")


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """``-Xptxas -v``'s report, one dict a function: ``registers``,
    ``smem_bytes``, ``barriers``, ``stack_bytes``, ``spill_stores`` and
    ``spill_loads`` (bytes), each where ptxas printed it."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = _PTX_ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _PTX_FRAME.search(line)
        if m:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTX_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            for key, rx in (("smem_bytes", _PTX_SMEM), ("barriers", _PTX_BARRIERS)):
                m = rx.search(line)
                if m:
                    cur[key] = int(m.group(1))
    return out


def extract_cost(built: Any) -> dict[str, Any]:
    """The cost of a library, the port's counterpart of XLA's cost
    analysis of an executable: ``{"entries": {function: ptxas report}}``
    from a :class:`Built`'s compiler output; ``{"entries": {}}`` for
    anything else. Never raises."""
    log = getattr(built, "log", None)
    return {"entries": parse_ptxas(log) if isinstance(log, str) else {}}


def record_cost(key: Any, built: Any) -> dict[str, Any]:
    """Extract and memoize the cost of ``built`` under ``key``."""
    cost = extract_cost(built)
    with _LOCK:
        _COST_CACHE[key] = cost
    return cost


def cost_of(key: Any) -> dict[str, Any] | None:
    """The ptxas report of a library acquired under ``key``: from this
    process's builds, else from the disk tier's sidecar (no ``nvcc``, no
    library touched); ``None`` when neither has it."""
    with _LOCK:
        got = _COST_CACHE.get(key)
    if got is None and _DISK is not None:
        dk = disk_key(key)
        side = _DISK.cost(dk) if dk is not None else None
        if side is not None:
            got = side
            with _LOCK:
                _COST_CACHE[key] = got
    return got


# ---------------------------------------------------------------------------
# disk-tier keying


class _Uncacheable(TypeError):
    """A key component with no stable canonical form: the entry stays
    memo-only, never wrongly shared."""


def _canon(o: Any) -> str:
    """Deterministic canonical string of a cache-key component:
    primitives, nested tuples/lists/dicts/sets and config dataclasses.
    Anything else raises :class:`_Uncacheable`."""
    if o is None or isinstance(o, (bool, int, float, str, bytes)):
        return repr(o)
    if isinstance(o, (tuple, list)):
        return "(" + ",".join(_canon(x) for x in o) + ")"
    if isinstance(o, dict):
        items = sorted(o.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(f"{_canon(k)}:{_canon(v)}" for k, v in items) + "}"
    if isinstance(o, (set, frozenset)):
        return "s{" + ",".join(sorted(_canon(x) for x in o)) + "}"
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        return type(o).__name__ + _canon(dataclasses.asdict(o))
    raise _Uncacheable(f"no canonical form for {type(o).__name__}")


def fingerprint_parts() -> dict[str, str]:
    """The fields of :func:`backend_fingerprint`: ``torch`` (the version),
    ``cuda`` (the runtime torch was built for), ``nvcc`` (``nvcc
    --version``), ``device`` (the card's name) and ``capability``
    (``sm_XY``; empty without a card)."""
    import torch

    from crosscoder_tpu_torch.ops import _build

    try:
        if torch.cuda.is_available():
            i = torch.cuda.current_device()
            major, minor = torch.cuda.get_device_capability(i)
            dev, cap = torch.cuda.get_device_name(i), f"sm_{major}{minor}"
        else:
            dev, cap = "none", ""
    except Exception:  # noqa: BLE001 — a broken CUDA install keys as its own device
        dev, cap = "unknown", ""
    return {"torch": str(torch.__version__), "cuda": str(torch.version.cuda),
            "nvcc": _build.nvcc_version(), "device": dev, "capability": cap}


def fingerprint_of(parts: dict[str, Any]) -> str:
    """The fingerprint string of :func:`fingerprint_parts`' fields."""
    dev = f"{parts['device']},{parts['capability']}" if parts["capability"] else parts["device"]
    return (f"torch={parts['torch']},cuda={parts['cuda']},"
            f"nvcc={parts['nvcc']},device={dev}")


def backend_fingerprint() -> str:
    """The build environment a stored library is valid under: the torch
    version, the CUDA runtime torch was built for, ``nvcc --version``, and
    the card's name and compute capability. Part of every disk key and
    stored in every entry, so an ``nvcc`` upgrade or another card makes an
    old entry unreachable and, found anyway, unloadable."""
    return fingerprint_of(fingerprint_parts())


def key_digest(key: Any, fingerprint: str, fmt: Any = DISK_FORMAT) -> str | None:
    """sha256 of the disk format ``fmt``, ``fingerprint`` and the canonical
    ``key``; ``None`` when a component of ``key`` has no canonical form.
    Pure: the compile tier's key rule (``cache-key-completeness``) perturbs
    each input through it."""
    try:
        canon = _canon(key)
    except _Uncacheable:
        return None
    blob = f"v{fmt}\x1f{fingerprint}\x1f{canon}"
    return hashlib.sha256(blob.encode()).hexdigest()


def disk_key(key: Any) -> str | None:
    """Content digest a memo key persists under: :func:`key_digest` of the
    disk format, the backend fingerprint and the canonical key (``_build``'s
    carries the hash of the source, every header and the flags). ``None``
    when a component has no canonical form: memo-only."""
    return key_digest(key, backend_fingerprint())


# ---------------------------------------------------------------------------
# disk tier


def _atomic_write(path: Path, data: bytes) -> None:
    """tmp + rename: a reader never sees a torn file."""
    tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{threading.get_ident()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _sha256_file(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


class DiskCache:
    """One directory of kernel libraries and their sidecars.

    Layout (under ``<root>/v{DISK_FORMAT}/``):

    - ``<digest>.so``: the library, placed by rename only;
    - ``<digest>.meta.json``: ``{format, fingerprint, src_sha, lib_sha}``
      (the hash of source + headers + flags and the library's own hash),
      written before the library appears;
    - ``<digest>.cost.json``: ptxas's report a function
      (:func:`extract_cost`), so :func:`cost_of` answers without ``nvcc``;
    - ``<digest>.claim``: the build leader's marker (claim by link; one
      winner, peers load the winner's entry);
    - ``manifest.json``: the advisory index ``{version, entries: {digest:
      {bytes, variant, topology, created, last_used}}}``, JAX's schema;
      eviction trusts the files, so a lost manifest update strands no bytes.

    A corrupt entry (no readable metadata, or a library that does not
    load), a stale one (format or fingerprint) and, under
    ``verify="strict"``, a tampered one (either hash) is a miss: the
    caller builds the library anew with ``nvcc``.
    """

    def __init__(self, root: str | os.PathLike, *,
                 max_bytes: int = 1 << 30, registry: Any = None) -> None:
        self.root = Path(root) / f"v{DISK_FORMAT}"
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.registry = registry
        self.stats = {"disk_hit": 0, "disk_miss": 0, "evictions": 0}
        self._lock = threading.Lock()

    # -- counters --------------------------------------------------------

    def _count(self, what: str) -> None:
        with self._lock:
            self.stats[what] += 1
        if self.registry is not None:
            self.registry.count(f"compile/{what}")

    # -- manifest (advisory; atomic read-modify-write) -------------------

    @property
    def manifest_path(self) -> Path:
        return self.root / "manifest.json"

    def manifest(self) -> dict:
        try:
            man = json.loads(self.manifest_path.read_text())
            if not isinstance(man, dict) or not isinstance(man.get("entries"), dict):
                raise ValueError("ill-typed manifest")
            return man
        except (OSError, ValueError):
            # absent / torn / corrupt: advisory data, start fresh
            return {"version": DISK_FORMAT, "entries": {}}

    def _update_manifest(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            man = self.manifest()
            try:
                fn(man)
                _atomic_write(self.manifest_path, json.dumps(man, sort_keys=True).encode())
            except OSError:
                pass        # the manifest is advisory; the files are the truth

    # -- entries ---------------------------------------------------------

    def lib_path(self, digest: str) -> Path:
        return self.root / f"{digest}.so"

    def _meta_path(self, digest: str) -> Path:
        return self.root / f"{digest}.meta.json"

    def _cost_path(self, digest: str) -> Path:
        return self.root / f"{digest}.cost.json"

    def _claim_path(self, digest: str) -> Path:
        return self.root / f"{digest}.claim"

    def scratch_path(self, stem: str) -> Path:
        """A fresh file name in the tier's directory for a build to write
        (same filesystem, so :meth:`store` places it by rename)."""
        return self.root / f"{stem}.{os.getpid()}.{threading.get_ident()}.tmp"

    def has(self, digest: str) -> bool:
        return self.lib_path(digest).exists()

    def _discard(self, digest: str) -> None:
        for p in (self.lib_path(digest), self._meta_path(digest), self._cost_path(digest)):
            try:
                p.unlink()
            except OSError:
                pass
        self._update_manifest(lambda m: m["entries"].pop(digest, None))

    def load(self, digest: str, *, lower: Callable[[], str] | None = None,
             verify: str = "off") -> Any | None:
        """The library under ``digest``, loaded (``ctypes.CDLL``), or
        ``None`` (a miss). ``lower()`` gives the live hash of source +
        headers + flags, which ``verify="strict"`` holds the entry's to,
        beside the library's own hash (an entry it cannot verify misses)."""
        path = self.lib_path(digest)
        if not path.exists():
            self._count("disk_miss")
            return None
        try:
            rec = json.loads(self._meta_path(digest).read_text())
            if (not isinstance(rec, dict) or rec.get("format") != DISK_FORMAT
                    or rec.get("fingerprint") != backend_fingerprint()):
                self._count("disk_miss")
                return None
            if verify == "strict":
                if lower is None or rec.get("src_sha") is None:
                    self._count("disk_miss")
                    return None
                if rec["src_sha"] != lower() or rec.get("lib_sha") != _sha256_file(path):
                    print(f"[crosscoder_tpu_torch] compile cache: strict verify REJECTED "
                          f"{digest[:12]} (stored hash != live); rebuilding",
                          file=sys.stderr, flush=True)
                    self._discard(digest)
                    self._count("disk_miss")
                    return None
            lib = ctypes.CDLL(str(path))
        except (OSError, ValueError):
            # corrupt (no metadata, an unloadable library): drop it
            self._discard(digest)
            self._count("disk_miss")
            return None
        self._count("disk_hit")
        now = time.time()
        try:
            os.utime(path, (now, now))      # LRU recency = the library's mtime
        except OSError:
            pass
        self._update_manifest(
            lambda m: m["entries"][digest].__setitem__("last_used", now)
            if digest in m["entries"] else None)
        return lib

    def store(self, digest: str, built: Built, *, variant: str = "", topology: str = "",
              lower: Callable[[], str] | None = None) -> bool:
        """Place ``built``'s library under ``digest`` (its metadata and
        cost sidecar first, then the library by rename) and evict past the
        byte cap. Returns False, placing nothing, when the disk refuses
        (the scratch file is then the caller's)."""
        path = self.lib_path(digest)
        try:
            rec = {"format": DISK_FORMAT, "fingerprint": backend_fingerprint(),
                   "src_sha": lower() if lower is not None else None,
                   "lib_sha": _sha256_file(built.path)}
            _atomic_write(self._cost_path(digest),
                          json.dumps(extract_cost(built), sort_keys=True).encode())
            _atomic_write(self._meta_path(digest), json.dumps(rec, sort_keys=True).encode())
            n_bytes = built.path.stat().st_size
            os.replace(built.path, path)
        except OSError as e:
            print(f"[crosscoder_tpu_torch] compile cache: store of {variant or digest[:12]} "
                  f"skipped ({type(e).__name__}: {e})"[:300], file=sys.stderr, flush=True)
            return False
        now = time.time()

        def _add(man: dict) -> None:
            man["entries"][digest] = {
                "bytes": n_bytes, "variant": str(variant)[:120],
                "topology": str(topology)[:120], "created": now, "last_used": now,
            }
        self._update_manifest(_add)
        self._evict()
        return True

    def cost(self, digest: str) -> dict[str, Any] | None:
        """The cost sidecar under ``digest`` (no library touched)."""
        try:
            side = json.loads(self._cost_path(digest).read_text())
            return side if isinstance(side, dict) else None
        except (OSError, ValueError):
            return None

    # -- byte-capped LRU eviction ---------------------------------------

    def _evict(self) -> None:
        """Drop the least recently used entries until their libraries fit
        ``max_bytes``. Recency and size come from the ``.so`` files (mtime
        touched on every hit), not the advisory manifest."""
        try:
            entries = []
            total = 0
            for p in self.root.glob("*.so"):
                try:
                    st = p.stat()
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
            entries.sort()
            for _, size, p in entries:
                if total <= self.max_bytes:
                    break
                self._discard(p.name[:-len(".so")])
                total -= size
                self._count("evictions")
        except OSError:
            pass

    # -- build-leader claim (exactly one process builds) -----------------

    def claim(self, digest: str) -> bool:
        """Try to become the build leader for ``digest``: write a tmp
        marker and link it into place, one winner. A claim older than the
        TTL belongs to a dead leader and is stolen."""
        path = self._claim_path(digest)
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}-{threading.get_ident()}")
        try:
            tmp.write_text(str(os.getpid()))
            try:
                os.link(tmp, path)
                return True
            except FileExistsError:
                try:
                    if time.time() - path.stat().st_mtime > _CLAIM_TTL_S:
                        os.replace(tmp, path)   # steal the stale claim
                        tmp = None
                        return True
                except OSError:
                    pass
                return False
            except OSError:
                # a filesystem without hard links: O_EXCL instead
                try:
                    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    return True
                except OSError:
                    return False
        except OSError:
            return True     # cannot coordinate: build locally, do not wait
        finally:
            if tmp is not None:
                try:
                    tmp.unlink()
                except OSError:
                    pass

    def release(self, digest: str) -> None:
        try:
            self._claim_path(digest).unlink()
        except OSError:
            pass

    def wait_for(self, digest: str, *, lower: Callable[[], str] | None = None,
                 verify: str = "off", timeout_s: float | None = None) -> Any | None:
        """The claim's loser: poll for the leader's entry. Returns the
        loaded library, or ``None`` when the leader died (claim gone, no
        entry) or the wait lapsed; the caller then builds live and stores
        nothing, so as not to stomp the leader."""
        deadline = time.monotonic() + (_CLAIM_WAIT_S if timeout_s is None else timeout_s)
        while time.monotonic() < deadline:
            if self.lib_path(digest).exists():
                return self.load(digest, lower=lower, verify=verify)
            if not self._claim_path(digest).exists():
                return None         # the leader is gone without publishing
            time.sleep(0.05)
        return None


# ---------------------------------------------------------------------------
# module-level disk-tier state


_DISK: DiskCache | None = None
_VERIFY = "off"


def configure(cfg: Any = None, *, cache_dir: str | None = None,
              max_bytes: int | None = None, verify: str | None = None,
              registry: Any = None) -> DiskCache | None:
    """Point the disk tier at ``cfg.compile_cache_dir`` (or the explicit
    ``cache_dir``; ``$CROSSCODER_COMPILE_CACHE_DIR`` as the tooling
    fallback). An empty directory turns the tier off (``None``), the
    default. Idempotent a directory: configuring again rebinds the
    registry and the byte cap in place, so the counters survive. The
    Trainer, the serve engine, the fleet and the tuner call it when they
    are built; a library already loaded stays loaded."""
    global _DISK, _VERIFY
    if cache_dir is None:
        cache_dir = str(getattr(cfg, "compile_cache_dir", "") or "")
    cache_dir = cache_dir or os.environ.get("CROSSCODER_COMPILE_CACHE_DIR", "")
    if verify is None:
        verify = str(getattr(cfg, "compile_cache_verify", "off") or "off")
    if max_bytes is None:
        max_bytes = int(getattr(cfg, "compile_cache_max_bytes", 1 << 30))
    with _LOCK:
        _VERIFY = verify
        if not cache_dir:
            _DISK = None
            return None
        root = Path(cache_dir)
        if _DISK is not None and _DISK.root == root / f"v{DISK_FORMAT}":
            _DISK.max_bytes = int(max_bytes)
            if registry is not None:
                _DISK.registry = registry
            return _DISK
        try:
            _DISK = DiskCache(root, max_bytes=int(max_bytes), registry=registry)
        except OSError as e:
            print(f"[crosscoder_tpu_torch] compile cache: disk tier disabled "
                  f"({cache_dir!r} not usable: {e})", file=sys.stderr, flush=True)
            _DISK = None
        return _DISK


def disk_enabled() -> bool:
    return _DISK is not None


def disk_cache() -> DiskCache | None:
    """The active disk tier, or ``None`` when off."""
    return _DISK


def disk_entry_count() -> int:
    """Number of libraries in the active tier (0 when off)."""
    if _DISK is None:
        return 0
    try:
        return sum(1 for _ in _DISK.root.glob("*.so"))
    except OSError:
        return 0


def disk_stats() -> dict[str, int]:
    """Hit/miss/eviction counters of the active tier (zeros when off)."""
    if _DISK is None:
        return {"disk_hit": 0, "disk_miss": 0, "evictions": 0}
    with _DISK._lock:
        return dict(_DISK.stats)


def _settle_from_disk(key: Any, dk: str | None) -> None:
    """After a disk hit: the cost table from the sidecar."""
    side = _DISK.cost(dk) if (_DISK is not None and dk) else None
    if side is not None:
        with _LOCK:
            _COST_CACHE.setdefault(key, side)


def _variant_hint(key: Any) -> str:
    """Human-readable manifest label for a memo key."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return str(key)[:80]


def _open(built: Built) -> Any:
    """The library of a fresh build, loaded (its build may have loaded it)."""
    if built.handle is None:
        built.handle = ctypes.CDLL(str(built.path))
    return built.handle


def _unlink(path: Path) -> None:
    try:
        path.unlink()
    except OSError:
        pass


def _disk_acquire(dk: str | None, build: Callable[[], Any], *,
                  lower: Callable[[], str] | None = None,
                  variant: str = "", topology: str = "",
                  span: Callable[[str], Any] | None = None):
    """The acquisition protocol of :func:`aot_get`: load → (claim →
    build + store | wait → load) → live build. Returns ``(value, source,
    built)``: source ``"disk" | "build"``, ``built`` what ``build()``
    returned when it ran. ``span(source)`` wraps each part so that the
    ``compile`` span's source is honest."""
    disk = _DISK

    def _run(src: str, fn: Callable[[], Any]) -> Any:
        if span is not None:
            with span(src):
                return fn()
        return fn()

    if disk is None or dk is None:
        built = _run("build", build)
        return built, "build", built
    lib = _run("disk", lambda: disk.load(dk, lower=lower, verify=_VERIFY))
    if lib is not None:
        return lib, "disk", None
    if disk.claim(dk):
        try:
            if disk.has(dk):            # a leader published and released since the load
                lib = _run("disk", lambda: disk.load(dk, lower=lower, verify=_VERIFY))
                if lib is not None:
                    return lib, "disk", None
            built = _run("build", build)
            lib = _open(built)          # mapped before the rename: eviction cannot race it
            if not disk.store(dk, built, variant=variant, topology=topology, lower=lower):
                _unlink(built.path)
            return lib, "build", built
        finally:
            disk.release(dk)
    lib = disk.wait_for(dk, lower=lower, verify=_VERIFY)
    if lib is not None:
        return lib, "disk", None
    built = _run("build", build)        # the leader died: build, store nothing
    lib = _open(built)
    _unlink(built.path)
    return lib, "build", built


# ---------------------------------------------------------------------------
# the memo


def aot_get(key: Any, build: Callable[[], Any],
            on_build: Callable[[Any], None] | None = None, *,
            on_load: Callable[[Any], None] | None = None,
            lower: Callable[[], str] | None = None,
            topology: str = "", span: Callable[[str], Any] | None = None) -> Any:
    """Process-wide memo of built libraries, with the disk tier under it
    (:func:`configure`).

    With the tier off the memo holds whatever ``build()`` returns. With it
    on, ``build()`` writes a library and returns a :class:`Built` for it
    (:meth:`DiskCache.scratch_path` gives it a name in the tier), and the
    memo holds the loaded library (``ctypes.CDLL``): a hit's, or the fresh
    build's, placed in the tier. The caller owns the key's completeness;
    :func:`disk_key` adds the toolchain and the card.

    Thread-safe: the memo is a bounded LRU under a lock, and concurrent
    callers of one key coalesce onto ONE build (the others block on it).
    ``on_build(key)`` fires only when ``build()`` ran, ``on_load(key)`` on a
    disk hit. ``lower()`` gives the live hash of what the library is built
    from, for the strict verify; ``topology`` labels the manifest row;
    ``span(source)`` wraps the load and the build (the ``compile`` span).
    """
    with _LOCK:
        if key in _AOT_CACHE:
            _AOT_CACHE.move_to_end(key)
            return _AOT_CACHE[key]
        fl = _INFLIGHT.get(key)
        owner = fl is None
        if owner:
            fl = _INFLIGHT[key] = _Inflight()
    if not owner:
        return fl.wait()
    try:
        dk = disk_key(key) if _DISK is not None else None
        value, src, built = _disk_acquire(dk, build, lower=lower, variant=_variant_hint(key),
                                          topology=topology, span=span)
    except BaseException as e:
        fl.error = e
        with _LOCK:
            _INFLIGHT.pop(key, None)
        fl.event.set()
        raise
    if src == "build":
        record_cost(key, built)
    with _LOCK:
        _AOT_CACHE[key] = value
        _evict_memo_locked()
        _INFLIGHT.pop(key, None)
    fl.value = value
    fl.event.set()
    if src == "disk":
        _settle_from_disk(key, dk)
        if on_load is not None:
            on_load(key)
    elif on_build is not None:
        on_build(key)
    return value


# ---------------------------------------------------------------------------
# compile events


def observe_compiles(obs: Any) -> None:
    """Report every ``nvcc`` run of this process to ``obs.on_compile``
    until :func:`unobserve_compiles` (the Observability plane's lifetime)."""
    with _LOCK:
        if obs not in _OBSERVERS:
            _OBSERVERS.append(obs)


def unobserve_compiles(obs: Any) -> None:
    with _LOCK:
        if obs in _OBSERVERS:
            _OBSERVERS.remove(obs)


def report_compile(key: str, wall_s: float) -> None:
    """One ``nvcc`` run of ``key`` (a library's name) that took ``wall_s``."""
    with _LOCK:
        observers = list(_OBSERVERS)
    for obs in observers:
        obs.on_compile(key, wall_s)

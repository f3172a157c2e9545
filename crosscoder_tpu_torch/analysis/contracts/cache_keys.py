"""Persistent compile-cache key contracts (CacheKeyContext), ported from
:mod:`crosscoder_tpu.analysis.contracts.cache_keys`.

The JAX package's disk tier stores compiled step executables keyed by a
digest of the step knobs. PyTorch runs every step eagerly, so the one
thing the port compiles and stores is its ``nvcc`` kernel libraries
(:mod:`crosscoder_tpu_torch.ops._build` under
:mod:`crosscoder_tpu_torch.utils.compile_cache`). A library's disk key is
:func:`compile_cache.key_digest` of ``(name, _build.library_hash(source,
headers, flags))`` under the disk format and the backend fingerprint. If
an input that changes the library ever failed to feed that key, two
different libraries would collide on one entry and a warm start would
silently load the WRONG kernel: the one failure the tier may never have.

``cache-key-completeness`` is the JAX package's rule unchanged: for every
field of the key surface it perturbs the base dict with a sentinel value
and asserts the digest forks; a field whose perturbation leaves the digest
unchanged is a finding, and so is a listed field with no value (an input
that no longer exists: key-surface drift). The port's surface
(:func:`build_cache_key_context`) lists, for every library of
``_build.kernel_names()``: its ``.cu`` source, each ``csrc/*.cuh``, each
``NVCC_FLAGS`` entry, ``DISK_FORMAT`` and each fingerprint field (torch,
the CUDA runtime, ``nvcc --version``, the card's name and capability).
Its digest runs the real key code (``_build.library_hash`` and
``compile_cache.key_digest``), not a copy of it. No ``nvcc`` and no card:
it runs in milliseconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from crosscoder_tpu_torch.analysis.contracts.engine import Finding, Rule


@dataclass
class CacheKeyContext:
    """Inputs of the key-completeness check: the authoritative key
    surface, a base dict of its values, and the digest the disk tier
    actually uses."""

    kind: str = "cache_keys"
    fields: frozenset[str] = frozenset()
    base_cfg: dict[str, Any] = field(default_factory=dict)
    digest_fn: Callable[[dict[str, Any]], str] = lambda d: ""


def _as_bytes(v: Any) -> bytes:
    return v if isinstance(v, bytes) else repr(v).encode()


def library_surface() -> tuple[frozenset[str], dict[str, Any]]:
    """``(fields, base)``: every input of every library's disk key, named
    ``<library>/<input>``, and its value on this tree and machine (absent
    where the input does not exist)."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.utils import compile_cache

    csrc = _build.CSRC
    headers = [p.name for p in _build.header_paths()]
    parts = compile_cache.fingerprint_parts()
    fields: set[str] = set()
    base: dict[str, Any] = {}
    for name in _build.kernel_names():
        inputs = {f"{name}/source:{name}.cu": csrc / f"{name}.cu",
                  **{f"{name}/header:{h}": csrc / h for h in headers}}
        for key, path in inputs.items():
            fields.add(key)
            if path.is_file():
                base[key] = path.read_bytes()
        for i, flag in enumerate(_build.NVCC_FLAGS):
            fields.add(f"{name}/flag[{i}]")
            base[f"{name}/flag[{i}]"] = flag
        fields.add(f"{name}/format")
        base[f"{name}/format"] = compile_cache.DISK_FORMAT
        for part, value in parts.items():
            fields.add(f"{name}/fingerprint:{part}")
            base[f"{name}/fingerprint:{part}"] = value
    return frozenset(fields), base


def library_digests(d: dict[str, Any]) -> str:
    """Every library's disk key computed from the surface dict ``d`` by the
    real key code, one ``name=digest`` a library, joined."""
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.utils import compile_cache

    headers = [p.name for p in _build.header_paths()]
    out = []
    for name in _build.kernel_names():
        h = _build.library_hash(
            _as_bytes(d.get(f"{name}/source:{name}.cu")),
            [_as_bytes(d.get(f"{name}/header:{x}")) for x in headers],
            [str(d.get(f"{name}/flag[{i}]")) for i in range(len(_build.NVCC_FLAGS))])
        fp = compile_cache.fingerprint_of(
            {p: d.get(f"{name}/fingerprint:{p}") for p in
             ("torch", "cuda", "nvcc", "device", "capability")})
        out.append(f"{name}={compile_cache.key_digest((name, h), fp, d.get(f'{name}/format'))}")
    return ";".join(out)


def build_cache_key_context() -> CacheKeyContext:
    """Context over the REAL surfaces: every kernel library's inputs on
    this tree and machine, and the disk key ``compile_cache`` stores it
    under."""
    fields, base = library_surface()
    return CacheKeyContext(fields=fields, base_cfg=base, digest_fn=library_digests)


def _is_cache_ctx(ctx: Any) -> bool:
    return getattr(ctx, "kind", "") == "cache_keys"


# a value no input legitimately takes — guaranteed different from any real
# setting
_SENTINEL = ("__cache_key_mutant__",)


def _check_completeness(ctx: CacheKeyContext) -> list[Finding]:
    out: list[Finding] = []
    base_digest = ctx.digest_fn(dict(ctx.base_cfg))
    for name in sorted(ctx.fields):
        if name not in ctx.base_cfg:
            out.append(Finding(
                rule="cache-key-completeness", location=name,
                message=f"the key surface names '{name}' but it has no "
                        f"value — the key surface and the inputs it lists "
                        f"have drifted apart",
            ))
            continue
        perturbed = dict(ctx.base_cfg)
        perturbed[name] = _SENTINEL
        if ctx.digest_fn(perturbed) == base_digest:
            out.append(Finding(
                rule="cache-key-completeness", location=name,
                message=f"perturbing '{name}' does not change the "
                        f"disk-cache digest — two different libraries "
                        f"would collide on one persisted entry (a warm "
                        f"start could load the wrong kernel)",
            ))
    return out


CACHE_RULES: list[Rule] = [
    Rule("cache-key-completeness",
         "every input of a kernel library forks its compile-cache key",
         _is_cache_ctx, _check_completeness),
]

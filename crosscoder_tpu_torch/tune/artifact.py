"""The pinned ``TUNED.json`` artifact: schema, load and apply, the topology
cache; ported from :mod:`crosscoder_tpu.tune.artifact`.

A tune run ends in one small JSON document: the chosen knobs, the grid
they were searched at, the stage-1 cost model's predictions, the stage-2
measured scores, the gate's audit and a hash of the fully resolved config.
A deployment pins exactly what the search found, and ``--tuned <path>``
reproduces it through the normal config resolution
(:meth:`~crosscoder_tpu_torch.config.CrossCoderConfig.from_cli`).

The document is the JAX package's, byte for byte: the same keys, written
with ``sort_keys`` and ``indent=2``, so either package loads and applies
what the other wrote (the config hash is equal for equal configs).

Artifacts are cached per topology (``TUNED.<topology>.json`` siblings of
the loaded artifact), so a re-mesh to a shape searched before is a file
read, not a new search (:func:`on_remesh`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
from pathlib import Path
from typing import Any

SCHEMA_VERSION = 1

# every key a well-formed artifact carries, with its type: load_tuned() and
# the report validate against this table
_REQUIRED: tuple[tuple[str, type], ...] = (
    ("version", int),
    ("objective", str),
    ("knobs", dict),
    ("mesh", dict),
    ("predicted", dict),
    ("measured", dict),
    ("gate", dict),
    ("search", dict),
    ("config_hash", str),
)


def topology_key(n_devices: int, n_model: int = 1) -> str:
    """The topology tag an artifact is keyed by: the device count and the
    TP width, the two inputs that change the step and the DP ring's width."""
    return f"d{int(n_devices)}m{int(n_model)}"


def config_hash(cfg: Any) -> str:
    """SHA-256 of the fully resolved config's JSON, less the artifact path
    itself (which would make the hash refer to itself)."""
    d = cfg.to_dict()
    d.pop("tuned", None)
    return hashlib.sha256(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()


@dataclasses.dataclass
class TunedArtifact:
    """One pinned tune result (the module docstring gives each field)."""

    objective: str
    knobs: dict[str, Any]
    mesh: dict[str, int]
    predicted: dict[str, Any] = dataclasses.field(default_factory=dict)
    measured: dict[str, Any] = dataclasses.field(default_factory=dict)
    gate: dict[str, Any] = dataclasses.field(default_factory=dict)
    search: dict[str, Any] = dataclasses.field(default_factory=dict)
    config_hash: str = ""
    version: int = SCHEMA_VERSION

    @property
    def topology(self) -> str:
        return topology_key(self.mesh.get("n_devices", 1), self.mesh.get("n_model", 1))

    def to_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["topology"] = self.topology
        return d

    def save(self, path: str | Path) -> Path:
        """Atomic write (a temporary file, then a rename): a torn artifact
        never loads."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True, default=str))
        os.replace(tmp, path)
        return path

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TunedArtifact":
        for key, typ in _REQUIRED:
            if key not in d:
                raise ValueError(f"TUNED artifact missing required key {key!r}")
            if not isinstance(d[key], typ):
                raise ValueError(f"TUNED artifact key {key!r} must be {typ.__name__}, got "
                                 f"{type(d[key]).__name__}")
        if d["version"] != SCHEMA_VERSION:
            raise ValueError(f"TUNED artifact schema version {d['version']} != supported "
                             f"{SCHEMA_VERSION}")
        if not d["knobs"]:
            raise ValueError("TUNED artifact has an empty knob set — nothing to apply")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def load_tuned(path: str | Path) -> TunedArtifact:
    """Parse and validate one artifact; :class:`ValueError` on anything
    malformed (an unreadable file, not JSON, keys missing or of the wrong
    type)."""
    try:
        data = json.loads(Path(path).read_text())
    except OSError as e:
        raise ValueError(f"cannot read {path}: {e}")
    except json.JSONDecodeError as e:
        raise ValueError(f"{path} is not valid JSON: {e}")
    if not isinstance(data, dict):
        raise ValueError(f"{path}: top-level JSON must be an object")
    return TunedArtifact.from_dict(data)


def apply_tuned(cfg: Any, path: str | Path | None = None) -> Any:
    """``cfg`` with the artifact's knobs applied over it, validated again by
    the config's own checks: a stale artifact whose knobs no longer pass
    fails here, not hours into a run. ``path`` defaults to ``cfg.tuned``;
    with neither set this is the identity. A knob that is not a config
    field is refused."""
    path = path if path is not None else getattr(cfg, "tuned", "")
    if not path:
        return cfg
    art = load_tuned(path)
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    unknown = sorted(set(art.knobs) - fields)
    if unknown:
        raise ValueError(f"TUNED artifact {path} carries unknown knob(s) {unknown} — not "
                         f"CrossCoderConfig fields")
    knobs = dict(art.knobs)
    # JSON has no tuples: a tuple field's list comes back as a tuple
    for k, v in knobs.items():
        if isinstance(getattr(cfg, k), tuple) and isinstance(v, list):
            knobs[k] = tuple(v)
    return cfg.replace(tuned=str(path), **knobs)


# ---------------------------------------------------------------------------
# the per-topology cache (the re-tune at a re-mesh)


def cache_path(root: str | Path, topology: str) -> Path:
    return Path(root) / f"TUNED.{topology}.json"


def cached_artifact(root: str | Path, topology: str) -> TunedArtifact | None:
    """The pinned artifact for ``topology`` under ``root``, or None. A
    malformed entry is a miss (said on stderr), never an error: the re-mesh
    must not die on a torn file."""
    p = cache_path(root, topology)
    if not p.exists():
        return None
    try:
        return load_tuned(p)
    except ValueError as e:
        print(f"[crosscoder_tpu_torch] tune: ignoring malformed cached artifact {p}: {e}",
              file=sys.stderr, flush=True)
        return None


def on_remesh(cfg: Any, n_devices: int) -> tuple[Any, str]:
    """The re-mesh hook: the elastic controller calls it when the world
    changes shape. With no pinned artifact (``cfg.tuned`` empty) it does
    nothing. Otherwise:

    - a cached ``TUNED.<topology>.json`` sibling for the NEW topology
      replaces the pinned knobs (``cache_hit``);
    - a pinned artifact searched at this topology stands (``current``);
    - else the pinned knobs are stale for this shape: the config comes back
      unchanged but flagged, so the caller counts it and a re-tune can be
      scheduled (``stale``).

    Returns ``(cfg, status)``, status one of ``off``, ``current``,
    ``cache_hit``, ``stale``.
    """
    if not getattr(cfg, "tuned", ""):
        return cfg, "off"
    n_model = max(1, int(cfg.model_axis_size))
    topo = topology_key(n_devices, n_model)
    try:
        pinned = load_tuned(cfg.tuned)
    except ValueError:
        pinned = None
    if pinned is not None and pinned.topology == topo:
        return cfg, "current"
    cached = cached_artifact(Path(cfg.tuned).parent, topo)
    if cached is not None:
        path = cache_path(Path(cfg.tuned).parent, topo)
        print(f"[crosscoder_tpu_torch] tune: remesh to {topo} — applying cached artifact "
              f"{path}", file=sys.stderr, flush=True)
        return apply_tuned(cfg, path), "cache_hit"
    print(f"[crosscoder_tpu_torch] tune: remesh to {topo} — pinned artifact {cfg.tuned} was "
          f"searched at {pinned.topology if pinned else 'unknown'}; knobs are STALE, re-tune "
          f"recommended", file=sys.stderr, flush=True)
    return cfg, "stale"

"""Versioned checkpointing with full train-state resume, ported from
:mod:`crosscoder_tpu.checkpoint.ckpt`.

Layout, as the JAX package's (the reference's auto-versioned scheme):
``<base>/version_N/`` per run (N = 1 + the largest on disk), holding per
save ``v``:

- ``{v}.npz``: the crosscoder weights, f32, named ``W_enc``, ``W_dec``,
  ``b_enc``, ``b_dec`` (and ``log_theta`` for JumpReLU);
- ``{v}_cfg.json``: :meth:`CrossCoderConfig.to_json_str`;
- ``{v}_train_state.npz``: every leaf of the :class:`TrainState`, keyed by
  the JAX package's pytree paths (``.params['W_enc']``,
  ``.opt_state[1].mu['W_enc']``, ``.opt_state[1].count``,
  ``.opt_state[2].count``, ``.step``, ``.aux['steps_since_fired']``), so
  each package restores the other's saves; bf16 leaves are stored as
  2-byte void arrays (``V2``), as the JAX package's npz holds them;
- ``{v}_meta.json``, written last: ``step``, ``save_version``, ``format``,
  the buffer's ``state_dict()`` and the SHA-256 of each artifact.

Every artifact is written to a ``.tmp`` sibling, fsynced, renamed with
``os.replace`` and its directory fsynced, so a save is complete exactly
when its meta exists. ``save(background=True)`` copies the state to host
memory on the calling thread and writes on one writer thread; ``wait()``
joins it and raises its error. Restore picks the newest complete save
whose checksums verify, falling back past corrupt ones.

Across ranks (``mesh``, :mod:`crosscoder_tpu_torch.parallel.mesh`), as
the JAX package's multi-host save and restore: every rank enters
:meth:`Checkpointer.save`, which gathers the sharded leaves to full tensors
(a collective) and then lets only the primary rank write; a write still in
flight is waited for before the gather, and its error raised only after
it, so no rank is left alone in the collective. :meth:`Checkpointer.restore`
agrees on the save (the minimum of every rank's newest verified save), and
each rank takes its shard of it. The on-disk format is the single-device
one, so a save from any grid restores on one device and in the JAX
``Checkpointer``. The ``quant_grads`` residuals (``.aux['quant_ef']``,
``[n_data, L]`` a param) reset to zero when the restoring grid's ``data``
width differs from the save's.

A fleet tenant's saves (``Checkpointer(tenant=name)``, as the JAX
package's) live under ``<base>/tenants/<name>/`` with version dirs of
their own, so ``keep_saves`` counts and prunes each tenant's saves alone.

Recovery is counted on ``counters`` (a
:class:`~crosscoder_tpu_torch.utils.logging.ResilienceCounters`; the
Trainer shares its own): a restore that skips a save failing its checksum
bumps ``corrupt_artifact_skips``. ``chaos`` (a
:class:`~crosscoder_tpu_torch.resilience.Chaos`) corrupts an artifact of
a planned save once its meta marker lands.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.utils.device import resolve_device

FORMAT = "crosscoder_tpu/v1"
PARAM_NAMES = ("W_dec", "W_enc", "b_dec", "b_enc")
_ADAM, _SCHEDULE = ".opt_state[1]", ".opt_state[2]"


def param_names(cfg: CrossCoderConfig) -> tuple[str, ...]:
    """The param leaves ``cfg`` trains: :data:`PARAM_NAMES`, plus
    ``log_theta`` for JumpReLU."""
    return PARAM_NAMES + (("log_theta",) if cfg.activation == "jumprelu" else ())


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a finished ``os.replace`` survives power loss;
    each artifact's rename is synced before the next begins, so a durable
    meta implies durable artifacts."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_savez(path: Path, arrays: dict[str, np.ndarray]) -> str:
    """Write an npz all-or-nothing (tmp, fsync, rename, directory fsync);
    returns its SHA-256, hashed from the tmp file before the rename."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return digest


def _atomic_write_text(path: Path, text: str) -> str:
    """:func:`_atomic_savez` for text; returns the text's SHA-256."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path.parent)
    return hashlib.sha256(text.encode()).hexdigest()


# ---------------------------------------------------------------------------
# the TrainState as the JAX package's path-keyed leaves


def leaf_key(kind: str, name: str) -> str:
    """The JAX pytree-path key of a train-state leaf: ``kind`` params, mu,
    nu, aux or quant_ef (a residual of ``aux['quant_ef']``)."""
    if kind == "params":
        return f".params['{name}']"
    if kind in ("mu", "nu"):
        return f"{_ADAM}.{kind}['{name}']"
    if kind == "quant_ef":
        return f".aux['quant_ef']['{name}']"
    return f".aux['{name}']"


def state_spec(cfg: CrossCoderConfig, n_data: int = 1
               ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{leaf key: (shape, dtype)}`` of the train state ``cfg`` builds on
    a grid ``n_data`` ranks wide, in the JAX package's pytree-path keys
    (optax chain: clip, Adam, schedule)."""
    n, d, H = cfg.n_sources, cfg.d_in, cfg.dict_size
    dt = torch.float32 if cfg.master_dtype == "fp32" else torch.bfloat16
    shapes = {"W_dec": (H, n, d), "W_enc": (n, d, H), "b_dec": (n, d), "b_enc": (H,),
              "log_theta": (H,)}
    # log_theta (JumpReLU) and its moments stay f32 whatever the masters' dtype
    dts = {p: torch.float32 if p == "log_theta" else dt for p in shapes}
    names = param_names(cfg)
    spec = {f".params['{p}']": (shapes[p], dts[p]) for p in names}
    spec[f"{_ADAM}.count"] = ((), torch.int32)
    for moment in ("mu", "nu"):
        spec.update({f"{_ADAM}.{moment}['{p}']": (shapes[p], dts[p]) for p in names})
    spec[f"{_SCHEDULE}.count"] = ((), torch.int32)
    spec[".step"] = ((), torch.int32)
    if cfg.aux_k > 0 or cfg.resample_every > 0:
        spec[".aux['steps_since_fired']"] = ((H,), torch.int32)
        if cfg.aux_mask_every != 1:
            spec[".aux['dead_mask']"] = ((H,), torch.bool)
    if cfg.quant_grads and n_data > 1:
        from crosscoder_tpu_torch.parallel.quant_ar import padded_len

        for p in names:
            L = padded_len(int(np.prod(shapes[p])), n_data, cfg.quant_block)
            spec[leaf_key("quant_ef", p)] = ((n_data, L), torch.float32)
    return spec


def _host(t: Any) -> torch.Tensor:
    """A host tensor the caller owns (a CPU leaf is copied, since the
    background writer must not see later steps)."""
    if not torch.is_tensor(t):
        return torch.tensor(t, dtype=torch.int32)
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.to("cpu")


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as the npz stores it: bf16 as 2-byte void."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def flatten_state(state: Any) -> dict[str, torch.Tensor]:
    """The train state's leaves on the host, keyed as :func:`state_spec`.
    The port's single Adam count is written to both optax counters."""
    opt = state.opt_state
    names = sorted(state.params)
    leaves: dict[str, Any] = {leaf_key("params", p): state.params[p] for p in names}
    leaves[f"{_ADAM}.count"] = opt.count
    for moment in ("mu", "nu"):
        tree = getattr(opt, moment)
        leaves.update({leaf_key(moment, p): tree[p] for p in names})
    leaves[f"{_SCHEDULE}.count"] = opt.count
    leaves[".step"] = state.step
    for name, t in sorted((state.aux or {}).items()):
        if name == "quant_ef":
            leaves.update({leaf_key("quant_ef", p): t[p] for p in sorted(t)})
        else:
            leaves[leaf_key("aux", name)] = t
    return {k: _host(v) for k, v in leaves.items()}


def _leaf(raw: np.ndarray, key: str, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    if raw.shape != shape:
        raise ValueError(f"leaf {key}: checkpoint shape {raw.shape} != expected {shape}")
    if dtype == torch.bfloat16:
        if raw.dtype.itemsize != 2 or raw.dtype.kind not in "Viu":
            raise ValueError(f"leaf {key}: {raw.dtype} cannot hold bf16")
        return torch.from_numpy(np.ascontiguousarray(raw).view(np.int16)).view(torch.bfloat16)
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}[dtype]
    return torch.from_numpy(np.array(raw, dtype=np_dtype))


def _is_ef(key: str) -> bool:
    return key.startswith(".aux['quant_ef']")


def unflatten_state(leaves: dict[str, np.ndarray], cfg: CrossCoderConfig, device=None,
                    n_data: int = 1) -> Any:
    """A :class:`TrainState` on ``device`` from npz leaves keyed as
    :func:`state_spec` for a grid ``n_data`` ranks wide;
    :class:`ValueError` on a missing leaf, an extra one, a shape that
    differs or two optimizer counts that disagree. The ``quant_ef``
    residuals are the one exception (restore-with-respec, as the JAX
    package's): missing, extra or shaped for another ``data`` width, they
    reset to zero, which costs one step of re-accumulated quantization
    error."""
    from crosscoder_tpu_torch.train.state import AdamState, TrainState

    spec = state_spec(cfg, n_data)
    if (sum(not _is_ef(k) for k in leaves) != sum(not _is_ef(k) for k in spec)):
        raise ValueError(f"checkpoint has {len(leaves)} leaves but state expects {len(spec)}; "
                         "optimizer chain or model shape changed since save")
    dev = resolve_device(device)
    t = {}
    resets = [k for k in leaves if _is_ef(k) and k not in spec]
    for key, (shape, dtype) in spec.items():
        if _is_ef(key) and (key not in leaves or leaves[key].shape != shape):
            resets.append(key)
            t[key] = torch.zeros(shape, dtype=dtype)
            continue
        if key not in leaves:
            raise ValueError(f"checkpoint is missing state leaf {key!r}; optimizer chain "
                             "changed since save (leaves are path-keyed)")
        t[key] = _leaf(leaves[key], key, shape, dtype)
    count, sched = int(t[f"{_ADAM}.count"]), int(t[f"{_SCHEDULE}.count"])
    if count != sched:
        raise ValueError(f"Adam count {count} != schedule count {sched}: the port keeps one "
                         "optimizer count")

    if resets:
        print(f"[crosscoder_tpu_torch] restore-with-respec: reset {len(resets)} quant_ef "
              f"leaf(s) to zero init (checkpoint mesh layout differs from target)",
              file=sys.stderr, flush=True)

    def tree(prefix):
        return {p: t[f"{prefix}['{p}']"].to(dev) for p in param_names(cfg)}

    aux = {key[len(".aux['"):-2]: v.to(dev) for key, v in t.items()
           if key.startswith(".aux[") and not _is_ef(key)}
    ef = {p: t[leaf_key("quant_ef", p)].to(dev) for p in param_names(cfg)
          if leaf_key("quant_ef", p) in spec}
    if ef:
        aux["quant_ef"] = ef
    return TrainState(params=tree(".params"),
                      opt_state=AdamState(count, tree(f"{_ADAM}.mu"), tree(f"{_ADAM}.nu")),
                      step=int(t[".step"]), aux=aux or None)


# ---------------------------------------------------------------------------


class Checkpointer:
    """Versioned saves under ``base_dir`` (default ``cfg.checkpoint_dir``),
    or under ``<base_dir>/tenants/<tenant>/`` for a fleet tenant
    (:class:`ValueError` for an empty name, one with ``/``, ``.`` or
    ``..``)."""

    def __init__(self, base_dir: str | Path | None = None,
                 cfg: CrossCoderConfig | None = None, chaos: Any | None = None,
                 counters: Any | None = None, tenant: str | None = None) -> None:
        if base_dir is None:
            base_dir = cfg.checkpoint_dir if cfg is not None else "./checkpoints"
        if tenant is not None:
            if not tenant or "/" in tenant or tenant in (".", ".."):
                raise ValueError(f"invalid tenant name {tenant!r}")
            base_dir = Path(base_dir) / "tenants" / tenant
        self.tenant = tenant
        self.base_dir = Path(base_dir)
        self.save_dir: Path | None = None
        self.save_version = 0
        self.chaos = chaos              # never called when None
        self.counters = counters        # the resilience/* channel
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    def _bump(self, name: str, n: int = 1) -> None:
        if self.counters is not None:
            self.counters.bump(name, n)

    def wait(self, raise_error: bool = True) -> None:
        """Join an in-flight background write; raise its error here (or
        keep it for a later :meth:`wait` with ``raise_error=False``)."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if raise_error and self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def _create_save_dir(self) -> None:
        self.base_dir.mkdir(parents=True, exist_ok=True)
        versions = [int(p.name.split("_")[1]) for p in self.base_dir.iterdir()
                    if p.is_dir() and p.name.startswith("version_")
                    and p.name.split("_")[1].isdigit()]
        self.save_dir = self.base_dir / f"version_{1 + max(versions) if versions else 0}"
        self.save_dir.mkdir(parents=True)

    # --- save ---------------------------------------------------------------
    def save(self, state: Any, cfg: CrossCoderConfig, buffer: Any | None = None,
             background: bool = False, mesh=None, buffer_state: dict | None = None
             ) -> Path | None:
        """Write one versioned save; returns the weights path (``None`` on
        a rank that is not the primary, which writes nothing). The stream
        position saved is ``buffer_state`` when given (one taken earlier),
        else ``buffer.state_dict()``. The state
        reaches host memory before this returns; ``background=True`` leaves
        the file writes to the writer thread (:meth:`wait` joins it). Under
        a ``mesh`` every rank must call this: the gather of the shards is a
        collective."""
        from crosscoder_tpu_torch.parallel import multihost

        with trace.span("save", version=self.save_version, background=background):
            # a write in flight lands before the gather, but its error waits
            # until after it: raising first would leave the other ranks alone
            # in the collective
            self.wait(raise_error=False)
            if mesh is not None:
                from crosscoder_tpu_torch.parallel.mesh import gather_state

                state = gather_state(mesh, state, cfg.shard_sources)
            self.wait()
            if not multihost.is_primary():
                self.save_version += 1
                return None
            leaves = flatten_state(state)
            weights = {p: leaves[f".params['{p}']"].float().numpy() for p in sorted(state.params)}
            flat = {k: _numpy(v) for k, v in leaves.items()}
            if self.save_dir is None:
                self._create_save_dir()
            v, save_dir = self.save_version, self.save_dir
            meta: dict[str, Any] = {"step": int(state.step), "save_version": v, "format": FORMAT}
            if buffer_state is not None:
                meta["buffer"] = buffer_state
            elif buffer is not None and hasattr(buffer, "state_dict"):
                meta["buffer"] = buffer.state_dict()

            def write() -> None:
                with trace.span("save_write", version=v):
                    meta["checksums"] = {
                        f"{v}.npz": _atomic_savez(save_dir / f"{v}.npz", weights),
                        f"{v}_cfg.json": _atomic_write_text(save_dir / f"{v}_cfg.json",
                                                            cfg.to_json_str()),
                        f"{v}_train_state.npz": _atomic_savez(
                            save_dir / f"{v}_train_state.npz", flat),
                    }
                    # meta last: its presence marks the save complete
                    _atomic_write_text(save_dir / f"{v}_meta.json", json.dumps(meta, indent=2))
                    self._prune_saves(save_dir, cfg.keep_saves)
                    if self.chaos is not None:
                        self.chaos.corrupt_save(save_dir, v)
                    print(f"Saved as version {v} in {save_dir}", file=sys.stderr)

            if background:
                def guarded() -> None:
                    try:
                        write()
                    except BaseException as e:      # raised by the next wait()
                        self._writer_error = e

                self._writer = threading.Thread(target=guarded, name="ckpt-writer")
                self._writer.start()
            else:
                write()
            self.save_version += 1
            return save_dir / f"{v}.npz"

    @staticmethod
    def _unlink_save(vdir: Path, v: int) -> None:
        # meta first: a crash midway leaves a torn (invisible) save, never a
        # meta vouching for deleted artifacts
        for name in (f"{v}_meta.json", f"{v}.npz", f"{v}_train_state.npz", f"{v}_cfg.json"):
            (vdir / name).unlink(missing_ok=True)

    @classmethod
    def _prune_saves(cls, save_dir: Path, keep: int) -> None:
        """Keep the newest ``keep`` complete saves (``keep <= 0``: all)."""
        if keep > 0:
            for old in cls.complete_saves(save_dir)[:-keep]:
                cls._unlink_save(save_dir, old)

    def discard_saves_after(self, version_dir: str | Path, v: int) -> None:
        """Delete every complete save newer than ``v`` in ``version_dir``
        (on the primary rank only, the one that writes)."""
        from crosscoder_tpu_torch.parallel import multihost

        if not multihost.is_primary():
            return
        vdir = Path(version_dir)
        for s in self.complete_saves(vdir):
            if s > v:
                self._unlink_save(vdir, s)

    # --- find ---------------------------------------------------------------
    @staticmethod
    def _version_dirs(base_dir: str | Path) -> list[Path]:
        base = Path(base_dir)
        return [p for _, p in sorted((int(p.name.split("_")[1]), p) for p in base.iterdir()
                                     if p.is_dir() and p.name.startswith("version_")
                                     and p.name.split("_")[1].isdigit())]

    @classmethod
    def latest_version_dir(cls, base_dir: str | Path) -> Path:
        versions = cls._version_dirs(base_dir)
        if not versions:
            raise FileNotFoundError(f"no version_* dirs under {base_dir}")
        return versions[-1]

    @staticmethod
    def complete_saves(version_dir: str | Path) -> list[int]:
        """Saves whose meta (written last) exists; a torn save has none."""
        return sorted(int(p.name.split("_")[0]) for p in Path(version_dir).glob("*_meta.json")
                      if p.name.split("_")[0].isdigit())

    @classmethod
    def verify_save(cls, version_dir: str | Path, v: int) -> bool:
        """Every artifact the meta vouches for exists and matches its
        SHA-256 (a meta with no checksums is trusted); an unreadable meta
        fails."""
        vdir = Path(version_dir)
        try:
            meta = json.loads((vdir / f"{v}_meta.json").read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            return False
        return all((vdir / name).exists() and _sha256_file(vdir / name) == want
                   for name, want in meta.get("checksums", {}).items())

    def _select_verified(self, version_dir: str | Path | None) -> tuple[Path, int]:
        """The newest save that verifies, in ``version_dir`` or else in every
        version dir newest first; corrupt saves are reported and skipped."""
        if version_dir is not None:
            dirs = [Path(version_dir)]
            if not self.complete_saves(dirs[0]):
                raise FileNotFoundError(f"no complete (meta-marked) save under {dirs[0]}; "
                                        "saves torn mid-write are not resumable")
        else:
            dirs = [d for d in reversed(self._version_dirs(self.base_dir))
                    if self.complete_saves(d)]
            if not dirs:
                raise FileNotFoundError(f"no version dir under {self.base_dir} holds a "
                                        "complete (meta-marked) save")
        for vdir in dirs:
            for v in reversed(self.complete_saves(vdir)):
                if self.verify_save(vdir, v):
                    return vdir, v
                self._bump("corrupt_artifact_skips")
                print(f"[crosscoder_tpu_torch] checkpoint save {v} in {vdir} failed checksum "
                      f"verification; falling back to the previous intact save",
                      file=sys.stderr, flush=True)
        raise FileNotFoundError(f"no complete save under {dirs} passed checksum verification")

    @classmethod
    def latest_save(cls, version_dir: str | Path) -> int:
        """The newest complete save; in a dir without metas, the newest
        weights-only save (``{v}.npz`` beside ``{v}_cfg.json``), unless a
        train state there shows the saves were torn."""
        saves = cls.complete_saves(version_dir)
        if not saves:
            vdir = Path(version_dir)
            if list(vdir.glob("*_train_state.npz")):
                raise FileNotFoundError(f"only torn (meta-less) saves under {version_dir}")
            saves = [int(p.stem) for p in vdir.glob("*.npz")
                     if p.stem.isdigit() and (vdir / f"{p.stem}_cfg.json").exists()]
        if not saves:
            raise FileNotFoundError(f"no saves under {version_dir}")
        return max(saves)

    # --- load ---------------------------------------------------------------
    @classmethod
    def load_weights(cls, version_dir: str | Path, save: int | None = None, device=None
                     ) -> tuple[dict[str, torch.Tensor], CrossCoderConfig]:
        """The crosscoder weights (f32, on ``device``) and cfg of a save:
        the analysis path."""
        vdir = Path(version_dir)
        v = cls.latest_save(vdir) if save is None else save
        cfg = CrossCoderConfig.from_json(vdir / f"{v}_cfg.json")
        dev = resolve_device(device)
        with np.load(vdir / f"{v}.npz") as z:
            params = {k: torch.from_numpy(np.array(z[k])).to(dev) for k in z.files}
        return params, cfg

    def _agree_min(self, x: int, mesh, device) -> int:
        """The smallest ``x`` over every rank of ``mesh`` (an all-reduce)."""
        import torch.distributed as dist

        from crosscoder_tpu_torch.parallel import collectives as coll

        t = torch.tensor([x], dtype=torch.int64).to(device)
        return int(coll.all_reduce_(t, mesh.world_group, dist.ReduceOp.MIN)[0])

    def restore(self, cfg: CrossCoderConfig, version_dir: str | Path | None = None,
                save: int | None = None, device=None, mesh=None) -> tuple[Any, dict]:
        """``(TrainState on device, meta)`` of a save. ``save=None`` takes
        the newest save that verifies (in ``version_dir``, or in any version
        dir); an explicit ``save`` must verify. Later saves continue in the
        restored save's version dir.

        Under a ``mesh`` every rank must call this. It first waits until
        every rank has landed its own background write (the primary's is
        the one on disk). With ``save=None`` the
        ranks agree on the save, as the JAX package's multi-host restore:
        the smallest version dir, then the smallest newest-verified save
        over every rank (a rank whose view is ahead falls back with the
        rest), verified again locally, else :class:`ValueError`. Each rank
        then takes its shard (no communication); the ``quant_ef`` residuals
        reset when the grid's ``data`` width differs from the save's."""
        with trace.span("restore"):
            self.wait()
            dev = resolve_device(device)
            if mesh is not None:
                # every rank past its wait() before any lists the saves: a
                # rank that read the directory while the primary's write was
                # still in flight would agree the ranks onto an older save
                self._agree_min(0, mesh, dev)
            if save is None:
                vdir, v = self._select_verified(version_dir)
                if mesh is not None:
                    if version_dir is None:
                        vnum = int(vdir.name.split("_")[1])
                        agreed_dir = self._agree_min(vnum, mesh, dev)
                        if agreed_dir != vnum:
                            vdir, v = self._select_verified(
                                self.base_dir / f"version_{agreed_dir}")
                    agreed = self._agree_min(v, mesh, dev)
                    if agreed != v:
                        print(f"[crosscoder_tpu_torch] restore agreement: local save {v} -> "
                              f"agreed save {agreed}", file=sys.stderr, flush=True)
                        v = agreed
                        if not self.verify_save(vdir, v):
                            raise ValueError(
                                f"agreed save {v} under {vdir} is missing or fails checksum "
                                "verification on this rank; refusing to load unverified state")
            else:
                vdir = Path(version_dir) if version_dir is not None else next(
                    (d for d in reversed(self._version_dirs(self.base_dir))
                     if self.complete_saves(d)), self.base_dir)
                v = save
                if not self.verify_save(vdir, v):
                    self._bump("corrupt_artifact_skips")
                    raise ValueError(f"checkpoint save {v} under {vdir} failed checksum "
                                     "verification (corrupt or truncated artifact)")
            n_data = mesh.data_size if mesh is not None else 1
            with np.load(vdir / f"{v}_train_state.npz") as z:
                state = unflatten_state({k: z[k] for k in z.files}, cfg, dev, n_data)
            if mesh is not None:
                from crosscoder_tpu_torch.parallel.mesh import shard_state

                state = shard_state(mesh, state, cfg.shard_sources)
            meta = json.loads((vdir / f"{v}_meta.json").read_text())
            self.save_dir, self.save_version = vdir, v + 1
            return state, meta

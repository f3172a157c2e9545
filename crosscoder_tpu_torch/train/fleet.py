"""The fleet: N crosscoders trained off one served stream, ported from
:mod:`crosscoder_tpu.train.fleet`.

A hyperparameter sweep (seeds, L1 strengths, dictionary sizes) pays the
harvest once a round instead of once a crosscoder: the
:class:`FleetScheduler` steps N *tenants* in lockstep off one activation
source.

- **One gather, one transfer a round.** Every tenant holds a cursor into
  the source's serve stream (the fan-out, :mod:`crosscoder_tpu_torch.data.fanout`):
  a round makes one real serve and one host→device copy of it, and hands
  that batch to every tenant's step. A tenant sees, batch for batch, what
  a solo :class:`~crosscoder_tpu_torch.train.trainer.Trainer` of its
  config would see from the same stream position.
- **Shape-identical tenants stack.** Tenants equal in everything but
  ``seed`` and ``l1_coeff`` (:func:`stack_signature`) form a cohort: one
  state stacked on a leading tenant axis and one step a round
  (:func:`crosscoder_tpu_torch.models.stacked.cohort_step`), whose
  optimizer update is one O1 launch with each tenant clipped by its own
  global norm.
- **Other tenants bucket.** Each other signature is a bucket: its own
  solo step (one O1 launch a round), at most ``cfg.fleet_max_buckets`` of
  them. In the JAX package a bucket is a compiled program keyed through
  ``compile_cache``; here it is the step closure, built at admission, and
  what compiles is the kernel libraries its steps launch: the scheduler
  configures the persistent tier (``cfg.compile_cache_dir``), so one fleet
  process runs ``nvcc`` for them and its peers load them.
- **Independent lifecycles.** A tenant admitted mid-run joins as a
  bucket at the live stream position; a retired tenant lands its save,
  frees its bucket (or leaves its cohort restacked at N−1) and detaches
  its cursor. Saves are per tenant under
  ``<checkpoint_dir>/tenants/<name>/`` (``Checkpointer(tenant=)``),
  metrics under ``tenant/<name>/…``, each group's step under a
  ``tenant_step`` span, and ``comm/h2d_transfers`` counts once a round.
- **Restore.** :meth:`FleetScheduler.save_all` saves every tenant at one
  round boundary with the same stream snapshot;
  :meth:`FleetScheduler.restore_all` restores every tenant and the stream.

Each tenant steps as its solo Trainer would, dead-latent resampling
included (a tenant's generator comes from its own ``seed``); the JAX
fleet's compiled step leaves resampling out.

On a rank grid (``mesh``, or ``cfg``'s axes over the joined process
group, as the :class:`~crosscoder_tpu_torch.train.trainer.Trainer` takes
it) each tenant's state is this rank's shards, as the mesh Trainer's; a
cohort stacks those shards on a leading tenant axis that no rank splits
(the JAX ``stacked_shardings``' leading ``None``). Each round every rank
serves the global batch and keeps its ``data`` rows (a source that
serves each rank its own rows, ``serves_local_rows``, is taken as it
serves); each member and bucket runs the mesh step body, the cohort's
norm of a tenant is its global norm over its shards; saves are the
gathered save and the agreed restore. Admission and retirement depend on
state every rank holds, so every rank keeps the same roster, and
:meth:`FleetScheduler.save_all`, :meth:`FleetScheduler.restore_all` and
:meth:`FleetScheduler.retire` are collectives: every rank calls them at
the same round, as is :meth:`FleetScheduler.remesh` onto another grid,
which restores every tenant from its newest save there. Runs on
``cuda`` unless ``device`` names another device; on the card every step
launches its kernels or raises.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any

import torch.distributed as dist

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import stacked
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.train import resample, schedules
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
from crosscoder_tpu_torch.train.trainer import (DeviceScale, _check_mesh, expand_metrics,
                                                make_step_body, resample_due, to_device,
                                                variant_for_step)
from crosscoder_tpu_torch.utils import compile_cache
from crosscoder_tpu_torch.utils.device import resolve_device

# cfg fields a tenant may vary and still stack with its cohort: seed only
# changes the init, l1_coeff only the member's own step body
_STACKABLE = ("seed", "l1_coeff")
# fields that never take part in grouping (run plumbing)
_NONSEMANTIC = ("checkpoint_dir", "fleet", "fleet_tenants", "fleet_max_buckets")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a name plus cfg-field overrides on the base config."""

    name: str
    overrides: dict[str, Any] = dataclasses.field(default_factory=dict)


def _parse_value(raw: str) -> Any:
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


def parse_tenants(spec: str) -> list[TenantSpec]:
    """Parse the ``cfg.fleet_tenants`` sweep spec ``"name:k=v,k=v;name2:k=v"``
    (overrides optional: ``"a;b:seed=7"``)."""
    out: list[TenantSpec] = []
    seen: set[str] = set()
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        name, _, kv = part.partition(":")
        name = name.strip()
        if not name or "/" in name:
            raise ValueError(f"invalid tenant name in fleet_tenants: {part!r}")
        if name in seen:
            raise ValueError(f"duplicate tenant name {name!r} in fleet_tenants")
        seen.add(name)
        overrides: dict[str, Any] = {}
        for item in filter(None, (i.strip() for i in kv.split(","))):
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(f"malformed override {item!r} (want k=v)")
            overrides[k.strip()] = _parse_value(v.strip())
        out.append(TenantSpec(name, overrides))
    return out


def tenant_config(base: CrossCoderConfig, spec: TenantSpec) -> CrossCoderConfig:
    """The tenant's solo config: ``base`` with the overrides and the fleet
    knobs cleared (a valid solo-run config), its batch plane pinned to the
    base's (the shared stream serves one batch shape)."""
    cfg = dataclasses.replace(base, fleet="off", fleet_tenants="", **spec.overrides)
    for field in ("batch_size", "d_in", "n_sources", "num_tokens", "enc_dtype"):
        if getattr(cfg, field) != getattr(base, field):
            # num_tokens too: total_steps sets the schedules and the shared
            # stream's length; a tenant ends early by retiring
            raise ValueError(f"tenant {spec.name!r} overrides {field}, which is pinned by the "
                             "shared harvest stream")
    if cfg.quant_grads:
        raise ValueError(f"tenant {spec.name!r} enables quant_grads, which the fleet step "
                         "cannot stack (config validation rejects it fleet-wide)")
    return cfg


def stack_signature(cfg: CrossCoderConfig) -> str:
    """Every field that shapes the step, canonically: two tenants stack iff
    their signatures match (they may then differ only in :data:`_STACKABLE`)."""
    d = dataclasses.asdict(cfg)
    for k in _STACKABLE + _NONSEMANTIC:
        d.pop(k, None)
    return json.dumps(d, sort_keys=True, default=str)


class _Tenant:
    """Book-keeping for one admitted tenant."""

    def __init__(self, spec: TenantSpec, cfg: CrossCoderConfig, checkpointer: Any | None) -> None:
        self.spec = spec
        self.name = spec.name
        self.cfg = cfg
        self.checkpointer = checkpointer
        self.steps_done = 0
        self.retired = False
        self.group: Any = None          # _Cohort or _Bucket


class _Cohort:
    """Shape-identical tenants on one stacked state."""

    def __init__(self, sig: str, tag: str, members: list[_Tenant]) -> None:
        self.sig = sig
        self.tag = tag
        self.members = members
        self.state = None               # stacked TrainState
        self.opt: Optimizer | None = None
        self.fns: dict[tuple, list] = {}     # variant -> one step body a member

    @property
    def cfg(self) -> CrossCoderConfig:
        return self.members[0].cfg


class _Bucket:
    """A tenant with a step signature of its own."""

    def __init__(self, sig: str, tag: str, tenant: _Tenant) -> None:
        self.sig = sig
        self.tag = tag
        self.tenant = tenant
        self.state = None
        self.opt: Optimizer | None = None
        self.fns: dict[tuple, Any] = {}


class FleetScheduler:
    """Run N crosscoder tenants in lockstep off one activation stream.

    ``cfg``: the base config, ``fleet="on"``; tenants come from
    ``cfg.fleet_tenants`` and :meth:`admit`. ``buffer``: the shared source,
    with the fan-out: the replay buffer (``next_raw_for``: raw rows, the
    norm factors applied in the step) or the synthetic source
    (``next_for``); default the synthetic source over the base cfg (the
    base seed drives the stream, tenant seeds only their init).
    ``checkpoint``: per-tenant checkpointers under ``cfg.checkpoint_dir``
    (when it is set). ``mesh``: the rank grid (default: ``cfg``'s axes over
    the joined process group whenever a group is joined or an axis above 1
    is asked for; none, one device, otherwise). Only the primary rank
    should carry a ``logger``.
    """

    def __init__(self, cfg: CrossCoderConfig, buffer: Any | None = None, mesh=None,
                 logger: Any | None = None, registry: Any | None = None,
                 checkpoint: bool = True, device=None) -> None:
        if cfg.fleet != "on":
            raise ValueError("FleetScheduler requires cfg.fleet='on'")
        if mesh is None and (dist.is_initialized() or cfg.model_axis_size > 1
                             or cfg.data_axis_size > 1):
            mesh = mesh_lib.mesh_from_cfg(cfg)
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        if buffer is None:
            from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

            buffer = SyntheticActivationSource(cfg)
        self.buffer = buffer
        self.logger = logger
        self.registry = registry
        # the persistent compile tier: the kernel libraries are built once
        # across fleet processes (one claims, its peers load)
        compile_cache.configure(cfg, registry=registry)
        self._checkpoint = checkpoint and bool(cfg.checkpoint_dir)
        self._raw_serving = hasattr(buffer, "next_raw_for")
        if not self._raw_serving and not hasattr(buffer, "next_for"):
            raise ValueError("fleet buffer must expose the fan-out protocol "
                             "(next_raw_for / next_for)")
        self._scale = DeviceScale(cfg.n_sources, self.device)
        self.rounds = 0
        self._tenants: dict[str, _Tenant] = {}
        self._cohorts: list[_Cohort] = []
        self._buckets: list[_Bucket] = []
        self._bucket_sigs: dict[str, int] = {}      # sig -> live tenants
        self._group_seq = 0
        specs = parse_tenants(cfg.fleet_tenants)
        if specs:
            self._admit_initial(specs)

    # -- admission / retirement ----------------------------------------

    def _admit_initial(self, specs: list[TenantSpec]) -> None:
        """Group the launch roster: a signature shared by two tenants or
        more is a cohort, any other tenant a bucket."""
        by_sig: dict[str, list[_Tenant]] = {}
        for spec in specs:
            t = self._new_tenant(spec)
            by_sig.setdefault(stack_signature(t.cfg), []).append(t)
        for sig, members in by_sig.items():
            if len(members) >= 2:
                self._build_cohort(sig, members)
            else:
                self._build_bucket(sig, members[0])

    def admit(self, spec: TenantSpec) -> None:
        """Admit a tenant mid-run, as a bucket whose cursor starts at the
        current stream position (a solo run launched now)."""
        t = self._new_tenant(spec)
        self._build_bucket(stack_signature(t.cfg), t)

    def _new_tenant(self, spec: TenantSpec) -> _Tenant:
        if spec.name in self._tenants:
            raise ValueError(f"tenant {spec.name!r} already admitted")
        cfg = tenant_config(self.cfg, spec)
        if self.mesh is not None:
            _check_mesh(cfg, self.mesh)
        ckpt = None
        if self._checkpoint:
            from crosscoder_tpu_torch.checkpoint import Checkpointer

            ckpt = Checkpointer(self.cfg.checkpoint_dir, cfg=cfg, tenant=spec.name)
        t = _Tenant(spec, cfg, ckpt)
        self.buffer.attach_consumer(spec.name)
        self._tenants[spec.name] = t
        return t

    def retire(self, name: str, save: bool = True) -> None:
        """Retire a tenant: land its save (``save``), free its bucket or
        restack its cohort at N−1, detach its cursor, join its writer."""
        t = self._tenants[name]
        if t.retired:
            return
        if save and t.checkpointer is not None:
            self._quiesce_refill()
            t.checkpointer.save(self._tenant_state(t), t.cfg, buffer=self._buffer_for_save(),
                                mesh=self.mesh)
        group = t.group
        if isinstance(group, _Bucket):
            self._buckets.remove(group)
            self._bucket_sigs[group.sig] -= 1
            if self._bucket_sigs[group.sig] <= 0:
                del self._bucket_sigs[group.sig]        # the bucket's slot is free
        else:
            i = group.members.index(t)
            group.members.pop(i)
            if group.members:
                group.state = stacked.restack_without(group.state, i)
                group.fns.clear()
            else:
                self._cohorts.remove(group)
        t.group = None
        t.retired = True
        self.buffer.detach_consumer(name)
        if t.checkpointer is not None:
            t.checkpointer.wait()
        if self.registry is not None:
            self.registry.count("tenant/retirements")

    def active(self) -> list[str]:
        return [n for n, t in self._tenants.items() if not t.retired]

    # -- groups ---------------------------------------------------------

    def _next_tag(self, kind: str) -> str:
        self._group_seq += 1
        return f"{kind}{self._group_seq}"

    def _init_state(self, cfg: CrossCoderConfig, opt: Optimizer):
        """A tenant's fresh state: its seed's, this rank's shards on a grid."""
        state = init_train_state(cfg, opt, device=self.device)
        if self.mesh is not None:
            state = mesh_lib.shard_state(self.mesh, state, cfg.shard_sources)
        return state

    def _build_cohort(self, sig: str, members: list[_Tenant]) -> None:
        co = _Cohort(sig, self._next_tag("cohort"), members)
        co.opt = Optimizer(co.cfg, schedules.lr_schedule(co.cfg))
        co.state = stacked.stack_states([self._init_state(m.cfg, co.opt) for m in members])
        for m in members:
            m.group = co
        self._cohorts.append(co)
        self._cohort_fns(co, variant_for_step(co.cfg, 0))
        if self.registry is not None:
            self.registry.count("tenant/admissions", len(members))

    def _build_bucket(self, sig: str, t: _Tenant) -> None:
        if sig not in self._bucket_sigs and len(self._bucket_sigs) >= self.cfg.fleet_max_buckets:
            self.buffer.detach_consumer(t.name)
            del self._tenants[t.name]
            raise ValueError(
                f"admitting tenant {t.name!r} needs a new compile bucket but "
                f"fleet_max_buckets={self.cfg.fleet_max_buckets} are in use; retire a tenant "
                "or raise the cap")
        b = _Bucket(sig, self._next_tag("bucket"), t)
        b.opt = Optimizer(t.cfg, schedules.lr_schedule(t.cfg))
        b.state = self._init_state(t.cfg, b.opt)
        t.group = b
        self._buckets.append(b)
        self._bucket_sigs[sig] = self._bucket_sigs.get(sig, 0) + 1
        self._bucket_fn(b, variant_for_step(t.cfg, 0))
        if self.registry is not None:
            self.registry.count("tenant/admissions")

    def _cohort_fns(self, co: _Cohort, key: tuple) -> list:
        fns = co.fns.get(key)
        if fns is None:
            fns = co.fns[key] = [make_step_body(m.cfg, co.opt, *key, mesh=self.mesh)
                                 for m in co.members]
        return fns

    def _bucket_fn(self, b: _Bucket, key: tuple) -> Any:
        fn = b.fns.get(key)
        if fn is None:
            fn = b.fns[key] = make_step_body(b.tenant.cfg, b.opt, *key, mesh=self.mesh)
        return fn

    # -- serving --------------------------------------------------------

    def _serve_round(self) -> Any:
        """Advance every active tenant's cursor one position: one real
        serve, the rest read the fan-out's cache (the same object). On a
        grid, this rank's ``data`` rows of it."""
        serve = self.buffer.next_raw_for if self._raw_serving else self.buffer.next_for
        batch = None
        for name in self.active():
            batch = serve(name)
        if batch is None:
            raise RuntimeError("fleet round with no active tenants")
        if self.mesh is not None and not getattr(self.buffer, "serves_local_rows", False):
            rows = batch.shape[0] // self.mesh.data_size
            batch = batch[self.mesh.data_rank * rows:(self.mesh.data_rank + 1) * rows]
        return batch

    # -- the lockstep round ---------------------------------------------

    def _resample(self, cfg: CrossCoderConfig, step: int, state, batch, scale):
        """``(state, n)`` after the resample the solo Trainer makes before
        step ``step`` (``(state, None)`` off its cadence)."""
        if not resample_due(cfg, step):
            return state, None
        gen = resample.resample_generator(cfg, step, self.device)
        return resample.make_resample_fn(cfg, self.mesh)(state, batch, scale, gen)

    def step_all(self, full_metrics: bool = True) -> dict[str, dict[str, Any]]:
        """One round: serve once, copy to the device once, step every
        group. Returns ``{tenant: metrics}`` on the device (no sync)."""
        dev_batch = to_device(self._serve_round(), self.device)
        scale = self._scale(self.buffer, self._raw_serving)
        if self.registry is not None:
            # one upload a round, whatever the tenant count
            self.registry.count("comm/h2d_transfers")
        out: dict[str, dict[str, Any]] = {}
        for co in self._cohorts:
            step = co.members[0].steps_done
            fns = self._cohort_fns(co, variant_for_step(co.cfg, step, full_metrics))
            resampled = {}
            for i, m in enumerate(co.members):
                new, n = self._resample(m.cfg, step, stacked.unstack_state(co.state, i),
                                        dev_batch, scale)
                if n is not None:
                    stacked.write_member(co.state, i, new)
                    resampled[m.name] = n
            with trace.span("tenant_step", group=co.tag, n=len(co.members)):
                co.state, mets = stacked.cohort_step(fns, co.opt, co.state, dev_batch, scale,
                                                     mesh=self.mesh)
            for m, md in zip(co.members, mets):
                if m.name in resampled:
                    md["resampled"] = resampled[m.name]
                m.steps_done += 1
                out[m.name] = md
        for b in self._buckets:
            t = b.tenant
            fn = self._bucket_fn(b, variant_for_step(t.cfg, t.steps_done, full_metrics))
            b.state, n = self._resample(t.cfg, t.steps_done, b.state, dev_batch, scale)
            with trace.span("tenant_step", group=b.tag, n=1):
                b.state, mets = fn(b.state, dev_batch, scale, donate=True)
            if n is not None:
                mets["resampled"] = n
            t.steps_done += 1
            out[t.name] = mets
        self.rounds += 1
        return out

    def _auto_retire(self) -> None:
        for name in self.active():
            t = self._tenants[name]
            if t.steps_done >= t.cfg.total_steps:
                self.retire(name, save=self._checkpoint)

    def run(self, rounds: int | None = None) -> int:
        """Rounds until every tenant retires (or ``rounds`` ran), logging
        and saving at the base cfg's cadences, then a final save. Returns
        the rounds run. A tenant restored at its last step retires before
        the first round (the JAX fleet steps it once more)."""
        cfg = self.cfg
        done = 0
        self._auto_retire()
        while self.active() and (rounds is None or done < rounds):
            log_now = cfg.log_every > 0 and self.rounds % cfg.log_every == 0
            mets = self.step_all(full_metrics=log_now)
            done += 1
            if log_now:
                self.publish(mets)
            if cfg.save_every > 0 and self._checkpoint and self.rounds % cfg.save_every == 0:
                self.save_all(background=True)
            self._auto_retire()
        if self._checkpoint:
            self.save_all()
        self.quiesce()
        return done

    def publish(self, mets: dict[str, dict[str, Any]]) -> None:
        """One round's metrics on the host under ``tenant/<name>/…``, to
        the registry's gauges and the logger."""
        flat: dict[str, float] = {}
        for name, md in mets.items():
            for k, v in expand_metrics(md, self._tenants[name].cfg.n_sources).items():
                flat[f"tenant/{name}/{k}"] = v
        if self.registry is not None:
            for k, v in flat.items():
                self.registry.gauge(k, v)
        if self.logger is not None and multihost.is_primary():
            self.logger.log(flat, step=self.rounds)

    # -- state / checkpoints --------------------------------------------

    def _tenant_state(self, t: _Tenant):
        g = t.group
        if isinstance(g, _Bucket):
            return g.state
        return stacked.unstack_state(g.state, g.members.index(t))

    def tenant_state(self, name: str):
        """Tenant ``name``'s train state (a cohort member's as views of the
        stacked leaves)."""
        return self._tenant_state(self._tenants[name])

    def _buffer_for_save(self) -> Any | None:
        return self.buffer if hasattr(self.buffer, "state_dict") else None

    def _quiesce_refill(self) -> None:
        """Drain the replay buffer's refill dispatcher before a stream
        snapshot (its thread moves the cycle state the snapshot reads)."""
        q = getattr(self.buffer, "_quiesce_dispatch", None)
        if q is not None:
            q()

    def quiesce(self) -> None:
        """Land every tenant's in-flight checkpoint write."""
        for t in self._tenants.values():
            if t.checkpointer is not None:
                t.checkpointer.wait()

    def save_all(self, background: bool = False) -> None:
        """One save per active tenant at this round boundary, all with the
        same stream snapshot, each under its ``tenants/<name>/``."""
        self._quiesce_refill()
        buf = self._buffer_for_save()
        for name in self.active():
            t = self._tenants[name]
            if t.checkpointer is not None:
                t.checkpointer.save(self._tenant_state(t), t.cfg, buffer=buf,
                                    background=background, mesh=self.mesh)

    def restore_all(self) -> dict[str, int]:
        """Restore every active tenant from its newest verified save and the
        stream from their common snapshot (a preempted fleet's resume).
        Returns each tenant's restored step."""
        self.quiesce()
        restored: dict[str, int] = {}
        stream_meta: dict | None = None
        per_tenant: dict[str, Any] = {}
        for name in self.active():
            t = self._tenants[name]
            if t.checkpointer is None:
                raise ValueError("restore_all needs tenant checkpointers")
            state, meta = t.checkpointer.restore(t.cfg, device=self.device, mesh=self.mesh)
            per_tenant[name] = state
            t.steps_done = int(meta["step"])
            restored[name] = t.steps_done
            if stream_meta is None and "buffer" in meta:
                stream_meta = meta["buffer"]
        for co in self._cohorts:
            co.state = stacked.stack_states([per_tenant[m.name] for m in co.members])
        for b in self._buckets:
            b.state = per_tenant[b.tenant.name]
        if stream_meta is not None and hasattr(self.buffer, "load_state_dict"):
            # rewinds the stream and puts every cursor at the restored head
            self.buffer.load_state_dict(stream_meta)
        return restored

    def remesh(self, mesh) -> None:
        """Elastic re-mesh onto ``mesh`` (a grid over the ranks present,
        every rank calling it): quiesce, re-derive every grid-coupled piece
        (the shared buffer's store, each cohort's and bucket's step bodies,
        each tenant's shards) and restore ALL tenants and the stream from
        their newest saves, the boundary the caller saved with
        :meth:`save_all`. The fleet's analogue of the Trainer's re-mesh and
        grow, in their order: the quiesce, ``prepare_reshard``, the new
        grid, ``reshard(refill=False)`` (the restore replays the save's
        stream position, not the live one), then :meth:`restore_all`, which
        takes each tenant's shards on the new grid."""
        self.quiesce()
        self._quiesce_refill()
        if hasattr(self.buffer, "prepare_reshard"):
            self.buffer.prepare_reshard()
        for t in self._tenants.values():
            if not t.retired:
                _check_mesh(t.cfg, mesh)
        self.mesh = mesh
        if hasattr(self.buffer, "reshard"):
            self.buffer.reshard(mesh, refill=False)
        for co in self._cohorts:
            co.state = None         # restored below, sharded for the new grid
            co.fns.clear()
        for b in self._buckets:
            b.state = None
            b.fns.clear()
        self.restore_all()
        print(f"[crosscoder_tpu_torch] fleet: re-meshed onto a {mesh.data_size} x "
              f"{mesh.model_size} grid and restored {len(self.active())} tenant(s)",
              flush=True, file=sys.stderr)

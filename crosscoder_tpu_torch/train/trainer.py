"""The single-device Trainer, ported from :mod:`crosscoder_tpu.train.trainer`.

Step math as the JAX package's (reference ``trainer.py:7-82``):
``loss = l2 + l1_coeff(step)·l1`` (+ the JumpReLU L0 term, its
coefficient ramped by the sparsity warmup, and the AuxK term on aux
steps), global norm clip at ``cfg.grad_clip``, Adam(β1, β2, eps 1e-8),
LR/L1 schedules at the pre-increment step, ``total_steps = num_tokens //
batch_size``. Each
step runs the variant ``(with_metrics, aux_on, mask_refresh)`` that
:func:`variant_for_step` picks, updates the AuxK fired-tracking
(``steps_since_fired``) and reports ``dead_frac``. Metrics stay on the
device until a log step reads them.

The data source is any object with ``next()`` returning a ``[batch,
n_sources, d_in]`` numpy array or tensor (the synthetic source), or with
``next_raw()`` and ``normalisation_factor`` (the replay buffer of
:mod:`crosscoder_tpu_torch.data.buffer`): raw bf16 rows, scaled by the
factors inside the step as the JAX trainer does.

Checkpoints (:class:`~crosscoder_tpu_torch.checkpoint.Checkpointer`), as
the JAX trainer's: a background save every ``save_every`` steps and one
more when ``train()`` ends, however it ends; ``cfg.resume`` restores the
newest verified save at construction (state, step, buffer position);
SIGTERM on the main thread finishes the step, saves and returns, and a
second SIGTERM falls through to the previous handler; on more than one
rank the ranks agree on the stop every ``cfg.stop_poll_every`` steps.

Recovery, as the JAX trainer's: dead-latent resampling
(``cfg.resample_every``, :mod:`crosscoder_tpu_torch.train.resample`) runs
before the step on the batch about to be trained; the loss guard
(``cfg.guard_loss``) checks the loss each log step already fetched and,
on a non-finite loss or a ``loss_spike_factor`` spike, restores the
newest save with finite params, skips the serves up to the detection
step and re-enters the loop, at most ``cfg.max_rollbacks`` times. The
recoveries count on :attr:`Trainer.resilience` (``resilience/*``). On a
grid both run on every rank: the resample edits each rank's shards from
the global tracker and the global batch; the guard's verdict, the
params' finiteness and the save it restores are agreed over the ranks,
and the restore is the checkpointer's agreed restore.

On a rank grid (``mesh``, :mod:`crosscoder_tpu_torch.parallel.mesh`: one
rank a device over ``torch.distributed``, ``data`` × ``model``), as the
JAX mesh trainer: each rank trains its rows of every global batch on its
shards of the dictionary axis; the loss and its statistics are global
(:func:`crosscoder_tpu_torch.models.crosscoder.get_losses` with the mesh),
the gradients of each leaf sum over ``data``, the clip reads the global
norm, and O1 updates each rank's shards. Under
``cfg.quant_grads`` (pure data parallelism) each rank's loss and
gradients are local and the gradients' mean goes through the int8
exchange (:mod:`crosscoder_tpu_torch.parallel.quant_ar`). Under
``cfg.shard_sources`` ``model`` splits the source axis instead of the
dictionary (:data:`crosscoder_tpu_torch.parallel.mesh._SOURCE_SPECS`). A
grid of one rank runs every collective and the merge as a wider one does.
A source that serves each rank its own rows (the mesh-sharded replay
store, ``serves_local_rows``) is taken as it serves; any other source
serves the global batch and each rank keeps its ``data`` rows.

N crosscoders off one stream (``cfg.fleet="on"``) train through
:class:`crosscoder_tpu_torch.train.fleet.FleetScheduler`, which runs this
module's step body (:func:`make_step_body`) for each tenant.

The one-deep batch prefetch (``cfg.prefetch``, on by default), as the
JAX trainer's: one worker thread serves batch i+1, cuts this rank's rows,
copies them to the device and uploads the scale while step i runs on the
device and its loss is read. One worker keeps the served stream, the
losses and the state bitwise those of ``prefetch=False``, which serves
inline. The next production is submitted once step i's launches are
queued (the JAX trainer submits it before its one dispatch): the step's
launches are hundreds of Python calls, and they do not then share the
interpreter with a serve. On the card the worker launches on a CUDA
stream of its own, which waits for the work queued before step i, so the
serve's device work (a refill's harvest, the copy) may run beside the
step's; the step's stream waits for an event recorded after the copy.
The copy leaves page-locked memory, so it does not block the worker: a
host store feeding a card serves page-locked rows, and a source whose
``next(out=...)`` fills an array handed in (the synthetic source) fills
one of two page-locked staging tensors in turn, each reused once the copy out of its last fill is done (a new
array of its size would cost the worker fresh pages every serve). With
more than one rank every launch site takes a ticket of a
:class:`~crosscoder_tpu_torch.utils.pipeline.LaunchSequencer` on the main
thread in program order and launches in its turn, so every rank issues
its collectives (a mesh store's reduce-scatter in the serve, the step's
all-reduces) in one order. A save records the stream as it stood before
the batch in flight was served; a restore that rewinds the stream drops
that batch.

Resilience, as the JAX trainer's: ``chaos`` (a
:class:`~crosscoder_tpu_torch.resilience.Chaos`) stalls, fails or
poisons planned serves, by a monotone serve index that skipped serves and
a batch dropped in flight also take; the poisoned row is written into a
copy of the batch (or into the trainer's own staging tensor), never into a
store's rows. ``cfg.harvest_timeout_s > 0`` runs each serve under a
:class:`~crosscoder_tpu_torch.resilience.Watchdog` (a stall waits on with
doubled patience, an exception is retried after a backoff; on the card the
watchdog's thread launches on the calling thread's stream), on one rank
only. The trainer's ``resilience`` counters are the checkpointer's too.

Observability (``cfg.obs="on"``, :class:`~crosscoder_tpu_torch.obs.Observability`):
the span tracer installed process-wide (``step`` around a step's
launches, ``refill_wait`` around taking the next batch, the buffer's,
checkpointer's and watchdog's spans), the refill bubble
(``perf/refill_bubble_frac``, ``perf/step_wall_ms``), ``comm/h2d_transfers``
once a production, ``comm/d2h_transfers`` once a log point's read, the
comm gauges of each step variant's first step, all merged into each log
line. A profiler window (``cfg.profile_steps``, the legacy
``cfg.profile_dir`` window, SIGUSR1;
:class:`~crosscoder_tpu_torch.obs.profiler.ProfilerWindow`) captures
chosen steps with ``torch.profiler``. Neither adds a launch, a device read
or a sync to a step. The compile events of the JAX plane have no
counterpart: nothing is compiled.

Elastic membership (``cfg.elastic="on"``,
:class:`~crosscoder_tpu_torch.resilience.elastic.ElasticController`), as
the JAX trainer's: a liveness probe before each step at the stop-poll
cadence; a failed probe (:class:`~crosscoder_tpu_torch.resilience.elastic.PeerLoss`)
or an exception the controller confirms as a torn collective leads to
:meth:`Trainer._remesh_and_resume`, which quiesces, shrinks the world to
the coordinator host's ranks, rebuilds what the grid shaped, reshards the
buffer and restores the newest verified save; anything else re-raises
unchanged. A rank that cannot survive raises ``PeerLoss`` out of
``train()`` and skips the final save. Scale-up (``cfg.elastic_grow="on"``):
chaos ``return@S`` opens the rejoin window at serve S; after the probe,
the shrunk survivors poll the rejoin board (``grow_ready``) and, when
candidates have passed the debounce and the dwell, grow at that step
boundary (:meth:`Trainer._grow_and_resume`: the boundary save every member
restores) and re-enter the loop on the wider grid.

Not ported in this slice (ROADMAP Queue A): the compile cache (A9b).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import inspect
import math
import signal
import sys
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.train import resample, schedules
from crosscoder_tpu_torch.parallel import quant_ar
from crosscoder_tpu_torch.resilience.elastic import ElasticController, PeerLoss
from crosscoder_tpu_torch.train.state import Optimizer, TrainState, init_train_state
from crosscoder_tpu_torch.utils import pipeline
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.logging import MetricsLogger, ResilienceCounters, source_tag


def variant_for_step(cfg: CrossCoderConfig, host_step: int, full_metrics: bool = True
                     ) -> tuple[bool, bool, bool]:
    """The step variant ``(with_metrics, aux_on, mask_refresh)`` that step
    ``host_step`` of a run under ``cfg`` executes (``aux_every``
    amortization of the AuxK term, ``aux_mask_every`` dead-mask caching)."""
    aux_on = cfg.aux_k == 0 or cfg.aux_every <= 1 or host_step % cfg.aux_every == 0
    cached_mask = (cfg.aux_k > 0 or cfg.resample_every > 0) and cfg.aux_mask_every != 1
    mask_refresh = not cached_mask or host_step % cfg.aux_mask_cadence == 0
    return (full_metrics, aux_on, mask_refresh)


def _reduce_metrics(metrics: dict[str, Any], divisors: dict[str, int], group
                    ) -> dict[str, Any]:
    """``metrics[k]`` summed over ``group`` and divided by ``divisors[k]``
    for each key of ``divisors``, in one all-reduce."""
    keys = [k for k in divisors if k in metrics]
    if not keys:
        return metrics
    parts = [metrics[k].detach().float().reshape(-1) for k in keys]
    flat = coll.all_reduce_(torch.cat(parts), group)
    out = dict(metrics)
    for k, v in zip(keys, flat.split([p.numel() for p in parts])):
        out[k] = (v / divisors[k]).reshape(metrics[k].shape)
    return out


def make_step_body(cfg: CrossCoderConfig, opt: Optimizer, with_metrics: bool = True,
                   aux_on: bool = True, mask_refresh: bool = True, mesh=None
                   ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                 tuple[TrainState, dict[str, Any]]]:
    """``step_fn(state, batch, scale, donate=False) -> (new_state,
    metrics)`` for one variant: ``x = batch · scale`` per source, value and
    gradients of :func:`crosscoder.training_loss`, the optimizer update and
    the AuxK bookkeeping. ``metrics`` hold device tensors (no sync).
    ``state`` stays intact unless ``donate=True``, which writes the new
    params and Adam moments into its tensors (the trainer's step).
    ``step_fn.loss_and_grads(state, batch, scale)`` gives the step's loss,
    loss surface and gradients without the update, and
    ``step_fn.finish(state, new_params, new_opt, loss, losses, dead)`` the
    step's state and metrics after an update made apart (the fleet's
    cohort update, :mod:`crosscoder_tpu_torch.models.stacked`, which builds
    one body a member from the member's own cfg, so each member's L1
    coefficient is its solo run's).

    Under a ``mesh`` ``state`` is this rank's shards and ``batch`` its
    rows. The loss is the global one on every rank, each rank's gradients
    of it (through its own rows) are summed over ``data`` in place, one
    all-reduce a leaf, and the metrics that are partials (l0, the
    explained variances, ``dead_frac``) are reduced in one all-reduce.
    With ``cfg.quant_grads`` on a ``data`` axis wider than 1 (the JAX
    ``quant_step_fn``): the loss and gradients are this rank's, the
    gradients' mean goes through the int8 exchange with error feedback
    (``aux["quant_ef"]``), every metric is a mean over ``data`` and
    ``fired`` an OR."""
    if cfg.batchtopk_threshold > 0:
        raise ValueError("cfg.batchtopk_threshold is an eval-mode setting; clear it "
                         "(0.0) before building a train step")
    lr_fn = schedules.lr_schedule(cfg)
    l1_fn = schedules.l1_coeff_schedule(cfg)
    warm_fn = schedules.sparsity_warmup_schedule(cfg)
    track_fired = cfg.aux_k > 0 or cfg.resample_every > 0
    cached_mask = track_fired and cfg.aux_mask_every != 1
    quant = mesh is not None and cfg.quant_grads and mesh.data_size > 1
    loss_mesh = mesh.local() if quant else mesh

    def _dead_mask(state: TrainState):
        if not track_fired:
            return None
        if cached_mask and not mask_refresh:
            return state.aux["dead_mask"]
        thresh = cfg.aux_dead_steps if cfg.aux_k > 0 else cfg.resample_threshold_steps
        return state.aux["steps_since_fired"] >= thresh

    def loss_and_grads(state: TrainState, batch: torch.Tensor, scale: torch.Tensor):
        """``(loss, losses, grads, dead, aux)`` of this variant at ``state``
        on ``batch``, with no update."""
        x = batch.float() * scale[None, :, None]
        names = sorted(state.params)
        params = {k: state.params[k].detach().requires_grad_(True) for k in names}
        kwargs: dict[str, Any] = {}
        dead = _dead_mask(state)
        aux = dead is not None and cfg.aux_k > 0 and aux_on
        if cfg.l0_coeff > 0:
            # L0 warms up over the same window as L1 and AuxK
            kwargs["l0_coeff"] = float(np.float32(cfg.l0_coeff) * warm_fn(state.step))
        if aux:
            kwargs["dead_mask"] = dead
            kwargs["aux_coeff"] = float(np.float32(cfg.aux_k_coeff) * warm_fn(state.step))
        loss, losses = cc.training_loss(params, x, float(l1_fn(state.step)), cfg, with_metrics,
                                        track_fired=track_fired, mesh=loss_mesh, **kwargs)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        if mesh is not None and not quant:
            # each rank's gradient of the global loss through its own rows:
            # the gradient is their sum over data (leaves in order), in f32
            # as the JAX step's psum is whatever the masters' dtype (a group
            # of one sums nothing, so its cast is skipped: the same bits)
            wide = coll.group_size(mesh.data_group) > 1
            for k in names:
                g = grads[k]
                if g.dtype == torch.float32 or not wide:
                    coll.all_reduce_(g, mesh.data_group)
                else:
                    grads[k] = coll.all_reduce_(g.float(), mesh.data_group).to(g.dtype)
        return loss.detach(), losses, grads, dead, aux

    def finish(state: TrainState, new_params, new_opt, loss, losses, dead, fired=None,
               new_ef=None) -> tuple[TrainState, dict[str, Any]]:
        """The state after the update (``new_params``, ``new_opt``) and the
        step's metrics: the AuxK bookkeeping from ``fired`` (default
        ``losses.fired``), the residuals ``new_ef`` of the exchange."""
        fired = losses.fired if fired is None else fired
        aux = dead is not None and cfg.aux_k > 0 and aux_on
        metrics: dict[str, Any] = {
            "loss": loss,
            "l2_loss": losses.l2_loss.detach(),
            "l1_loss": losses.l1_loss.detach(),
            "l1_coeff": float(l1_fn(state.step)),
            "lr": float(lr_fn(state.step)),
        }
        new_aux = state.aux
        if track_fired or new_ef is not None:
            new_aux = dict(state.aux)
        if new_ef is not None:
            new_aux["quant_ef"] = new_ef
        if track_fired:
            new_aux["steps_since_fired"] = torch.where(
                fired, 0, state.aux["steps_since_fired"] + 1).to(torch.int32)
            if cached_mask:
                new_aux["dead_mask"] = dead
            metrics["dead_frac"] = dead.float().mean()
            if aux:
                metrics["aux_loss"] = losses.aux_loss.detach()
        if with_metrics:
            metrics["l0_loss"] = losses.l0_loss.detach()
            metrics["explained_variance"] = losses.explained_variance.detach().mean()
            metrics["explained_variance_per_source"] = (
                losses.explained_variance_per_source.detach().mean(dim=-1))
        if mesh is not None:
            n, m = mesh.data_size, mesh.model_size
            if quant:       # every metric this rank's: their mean over data
                div = {k: n for k in ("loss", "l2_loss", "l1_loss", "aux_loss", "dead_frac",
                                      "l0_loss", "explained_variance",
                                      "explained_variance_per_source")}
            else:           # loss terms already global; l0 a partial, the rest replicated
                # (under shard_sources the dictionary is whole on every rank)
                div = {"dead_frac": n * m, "l0_loss": n * m if cfg.shard_sources else n,
                       "explained_variance": n * m, "explained_variance_per_source": n * m}
            metrics = _reduce_metrics(metrics, div, mesh.world_group)
        return TrainState(new_params, new_opt, state.step + 1, new_aux), metrics

    def step_fn(state: TrainState, batch: torch.Tensor, scale: torch.Tensor,
                donate: bool = False):
        loss, losses, grads, dead, _ = loss_and_grads(state, batch, scale)
        fired = losses.fired
        new_ef = None
        if quant:
            grads, new_ef = quant_ar.quantized_pmean_tree(grads, state.aux["quant_ef"],
                                                          mesh.data_group, cfg.quant_block)
            if track_fired:
                fired = mesh.any_(fired, "data")
        new_params, new_opt = opt.update(grads, state.opt_state, state.params, donate=donate,
                                         mesh=mesh)
        return finish(state, new_params, new_opt, loss, losses, dead, fired, new_ef)

    step_fn.loss_and_grads = loss_and_grads
    step_fn.finish = finish
    return step_fn


def expand_metrics(metrics: dict[str, Any], n_sources: int) -> dict[str, float]:
    """Host floats, with the per-source EV flattened into the reference's
    scalar names (``explained_variance_A``/``_B`` for two sources)."""
    out: dict[str, float] = {}
    for k, v in metrics.items():
        if k == "explained_variance_per_source":
            arr = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for i in range(n_sources):
                out[f"explained_variance_{source_tag(i)}"] = float(arr[i])
        else:
            out[k] = float(v)
    return out


def to_device(batch: Any, device) -> torch.Tensor:
    """A served batch on ``device``: the step's one host→device copy (a
    batch already there is not copied)."""
    if not torch.is_tensor(batch):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return batch.to(device, non_blocking=True)


class DeviceScale:
    """The step's per-source scale on ``device``: the source's
    ``normalisation_factor`` when it serves raw rows (scaled in the step),
    else ones. Uploaded again only when its values change."""

    def __init__(self, n_sources: int, device) -> None:
        self.n_sources = n_sources
        self.device = device
        self._src: np.ndarray | None = None
        self._dev: torch.Tensor | None = None

    def __call__(self, buffer: Any, raw: bool) -> torch.Tensor:
        src = getattr(buffer, "normalisation_factor", None)
        if raw and src is not None:
            vec = np.asarray(src, np.float32)
        else:
            vec = np.ones((self.n_sources,), np.float32)
        if self._src is None or not np.array_equal(self._src, vec):
            self._dev = torch.from_numpy(vec.copy()).to(self.device)
            self._src = vec.copy()
        return self._dev


def resample_due(cfg: CrossCoderConfig, step: int) -> bool:
    """Whether dead latents are resampled before optimizer step ``step``
    (on the batch about to be trained, so the revived latents' first
    gradients come from it)."""
    return cfg.resample_every > 0 and step > 0 and step % cfg.resample_every == 0


def _chain(exc: BaseException | None):
    """``exc`` and the exceptions it was raised from or during."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        yield exc
        exc = exc.__cause__ or exc.__context__


def _check_mesh(cfg: CrossCoderConfig, mesh: mesh_lib.Mesh) -> None:
    """Raise :class:`ValueError` for shapes the grid does not split, as the
    JAX mesh trainer's sharding does."""
    n, m = mesh.data_size, mesh.model_size
    if cfg.shard_sources and cfg.n_sources % m:
        raise ValueError(f"shard_sources: n_sources {cfg.n_sources} must divide by "
                         f"model_axis_size {m}")
    if not cfg.shard_sources and cfg.dict_size % m:
        raise ValueError(f"dict_size {cfg.dict_size} must divide by model_axis_size {m}")
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} must divide by the data axis {n}")


class Trainer:
    """Host loop around the step.

    ``buffer``: activation source with ``next_raw()`` or ``next()``
    (default: the synthetic source). ``state``: a starting :class:`TrainState` (default: a fresh
    one from ``cfg.seed``; :func:`crosscoder_tpu_torch.convert.train_state_from_numpy`
    carries a JAX one over). ``checkpointer``: where :meth:`save` writes and
    :meth:`restore` reads; with ``cfg.resume`` the newest verified save is
    restored here. Runs on ``cuda`` unless ``device`` names another device.

    ``mesh``: the rank grid to train on (default: ``cfg``'s axes over the
    joined process group, :func:`~crosscoder_tpu_torch.parallel.mesh.mesh_from_cfg`,
    whenever a group is joined or an axis above 1 is asked for; no mesh,
    the single-device step, otherwise). Every rank builds the same full
    state (or the caller's ``state``) and keeps its shards; each serve's
    global batch gives the rank its ``data`` rows. Metrics are global on
    every rank; only the primary rank should carry a ``logger``.

    ``chaos``: the fault plan (:class:`~crosscoder_tpu_torch.resilience.Chaos`,
    usually ``Chaos.from_cfg_env(cfg)``; the same object goes to the buffer
    and the checkpointer). ``cfg.obs``, ``cfg.profile_steps``,
    ``cfg.profile_dir`` and ``cfg.harvest_timeout_s`` behave as the JAX
    trainer's (module docstring).

    ``cfg.fleet="on"`` is a :class:`ValueError`: a fleet trains through
    :class:`~crosscoder_tpu_torch.train.fleet.FleetScheduler`.
    ``cfg.elastic="on"`` builds the elastic controller (inactive outside an
    elastic world of more than one rank: the trainer then trains as with
    it off); ``cfg.elastic_grow="on"`` adds the scale-up (module
    docstring). ``remat`` and ``compile_cache_dir``
    change only speed or memory in the JAX trainer, never results, so the
    port accepts and ignores them. ``prefetch`` (default on) serves the
    next batch on a worker thread while the step runs (module docstring);
    :meth:`close` stops the worker.
    """

    def __init__(self, cfg: CrossCoderConfig, buffer: Any | None = None,
                 logger: MetricsLogger | None = None, device=None,
                 state: TrainState | None = None, checkpointer: Any | None = None,
                 mesh: mesh_lib.Mesh | None = None, chaos: Any | None = None) -> None:
        if cfg.fleet == "on":
            raise ValueError("cfg.fleet='on' trains its tenants through "
                             "crosscoder_tpu_torch.train.fleet.FleetScheduler; the Trainer "
                             "trains one crosscoder (a tenant's config has fleet='off')")
        if mesh is None and (dist.is_initialized() or cfg.model_axis_size > 1
                             or cfg.data_axis_size > 1):
            mesh = mesh_lib.mesh_from_cfg(cfg)
        if mesh is not None:
            _check_mesh(cfg, mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.device = resolve_device(device)
        if buffer is None:
            from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

            buffer = SyntheticActivationSource(cfg)
        self.buffer = buffer
        # a source whose next() fills an array handed in (``out=``, its
        # ``batch_shape``): the prefetch worker serves it into staging
        nxt = getattr(buffer, "next", None)
        self._serves_into = (not hasattr(buffer, "next_raw") and hasattr(buffer, "batch_shape")
                             and nxt is not None and "out" in inspect.signature(nxt).parameters)
        self.logger = logger
        self.checkpointer = checkpointer
        self.total_steps = cfg.total_steps
        self.chaos = chaos              # fault plan; None: every hook is one is-None check
        # the recovery counters, shared with the checkpointer: its corrupt-
        # save skips land in the same resilience/* channel
        self.resilience = ResilienceCounters()
        if checkpointer is not None and getattr(checkpointer, "counters", None) is None:
            checkpointer.counters = self.resilience
        # elastic membership: None when off, so the loop carries is-None checks
        self._elastic = None
        self._world_lost = False        # this rank could not survive a peer loss
        self.last_remesh: dict | None = None
        self.last_grow: dict | None = None
        if cfg.elastic == "on":
            self._elastic = ElasticController(cfg, counters=self.resilience, chaos=chaos)
        self._watchdog = None
        if cfg.harvest_timeout_s > 0:
            if multihost.world_size() > 1:
                # a retry would launch a serve's collectives at a time of
                # this rank's own
                print("[crosscoder_tpu_torch] harvest watchdog disabled on a multi-process "
                      "mesh (retries would desync cross-host dispatch order)", file=sys.stderr,
                      flush=True)
            else:
                from crosscoder_tpu_torch.resilience.watchdog import Watchdog

                self._watchdog = Watchdog(cfg.harvest_timeout_s, retries=cfg.harvest_retries,
                                          backoff_s=cfg.harvest_backoff_s, name="harvest",
                                          counters=self.resilience)
        self._serve_count = 0           # monotone serve index, skipped serves included
        self._rollbacks = 0             # divergence rollbacks of this Trainer
        self._loss_ref: float | None = None   # last healthy logged loss
        self._resample_fn = None
        self.opt = Optimizer(cfg, schedules.lr_schedule(cfg))
        self.state = state if state is not None else init_train_state(
            cfg, self.opt, device=self.device,
            n_data=mesh.data_size if mesh is not None else None)
        # a step updates in place only a state this trainer made (init,
        # restore, an earlier step): a state handed in stays the caller's
        self._owns_state = state is None
        if mesh is not None:
            self.state = mesh_lib.shard_state(mesh, self.state, cfg.shard_sources)
            self._owns_state = True
        self._scale = DeviceScale(cfg.n_sources, self.device)
        self._step_fns: dict[tuple[bool, bool, bool], Callable] = {}
        # the telemetry plane (before a resume, so its restore is traced);
        # None when off: each hook below is one is-None check
        self._obs = None
        if cfg.obs == "on":
            from crosscoder_tpu_torch.obs import Observability

            self._obs = Observability(cfg, mesh=self.mesh)
        self._comm_accounted: set[tuple[bool, bool, bool]] = set()
        self._host_step = self.state.step
        # the one-deep prefetch: one worker, so the stream is the inline one
        self._prefetch_pool = None
        self._pending: concurrent.futures.Future | None = None
        self._buffer_snapshot: dict | None = None
        self._sequencer: pipeline.LaunchSequencer | None = None
        self._copy_stream = None
        self._staging: list[list[Any]] = []       # [page-locked tensor, its last copy's event]
        self._staging_turn = 0
        self._prefetch_end: int | None = None     # train()'s last step: nothing past it
        if cfg.prefetch:
            if multihost.needs_launch_tickets():
                self._sequencer = pipeline.LaunchSequencer()
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(device=self.device)
            self._prefetch_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="batch-prefetch")
        primary = multihost.is_primary()
        if cc.use_sparse_bwd(cfg, cfg.batch_size) and primary:
            print(f"[crosscoder_tpu_torch] sparse backward plane active "
                  f"({'K10 scatter kernel' if self.device.type == 'cuda' else 'plain scatter'})",
                  file=sys.stderr, flush=True)
        if cfg.resume:
            meta = self.restore()
            if primary:
                print(f"[crosscoder_tpu_torch] resumed at step {meta['step']}", file=sys.stderr,
                      flush=True)

    def save(self, background: bool = False) -> None:
        """Checkpoint the state and the buffer's position now (nothing
        without a checkpointer). ``background=True`` returns once the
        state is in host memory and writes on the checkpointer's thread."""
        if self.checkpointer is not None:
            # the worker idle and the refill drained, the stream recorded as
            # it stood before the batch in flight was served: a resume
            # replays that batch rather than skipping it
            self._drain_prefetch()
            self._quiesce_refill()
            snap = self._buffer_snapshot if self._pending is not None else None
            self.checkpointer.save(self.state, self.cfg, buffer=self.buffer,
                                   buffer_state=snap, background=background, mesh=self.mesh)

    def _quiesce_refill(self) -> None:
        """Drain the buffer's refill dispatcher, whose thread moves the
        cycle state the stream snapshot reads. A harvest error it reports
        does not stop the save (the snapshot is consistent either way, and
        a final save is when losing it hurts most): it is printed and
        dropped, as the JAX trainer does."""
        q = getattr(self.buffer, "_quiesce_dispatch", None)
        if q is None:
            return
        try:
            q()
        except Exception as e:  # noqa: BLE001 — reported; a lasting fault raises at the cycle end
            print(f"[crosscoder_tpu_torch] refill drain raised during save quiesce "
                  f"({type(e).__name__}: {e}); saving anyway"[:400], file=sys.stderr, flush=True)

    def restore(self, version_dir=None, save: int | None = None) -> dict:
        """Resume from a save (default: the newest that verifies): the
        train state, the host step and the buffer's position, or a fresh
        fill of the buffer when the save carries none. Returns its meta."""
        if self.checkpointer is None:
            raise ValueError("Trainer has no checkpointer to restore from")
        # the worker idle; its batch is dropped only if the stream rewinds
        self._drain_prefetch()
        self.state, meta = self.checkpointer.restore(self.cfg, version_dir, save,
                                                     device=self.device, mesh=self.mesh)
        self._owns_state = True
        self._host_step = self.state.step
        if "buffer" in meta and hasattr(self.buffer, "load_state_dict"):
            self._drain_prefetch(discard=True)
            self.buffer.load_state_dict(meta["buffer"])
        elif hasattr(self.buffer, "ensure_filled"):
            print("[crosscoder_tpu_torch] checkpoint has no buffer state; refilling fresh",
                  file=sys.stderr, flush=True)
            self.buffer.ensure_filled()
        return meta

    @property
    def step_counter(self) -> int:
        return self.state.step

    def _device_scale(self) -> torch.Tensor:
        """Per-source scale of the step (:class:`DeviceScale`; raw rows
        when the buffer serves ``next_raw``)."""
        return self._scale(self.buffer, hasattr(self.buffer, "next_raw"))

    def _take_serve_index(self) -> int:
        serve = self._serve_count
        self._serve_count += 1
        return serve

    def _serve_once(self, serve: int, out=None) -> Any:
        """Serve ``serve`` (an index of the monotone serve count, taken
        once a production, so a watched retry serves the same index) of
        the source (``next_raw`` when it has it, else ``next()``; into the
        array ``out`` when given), with the chaos hooks around it:
        ``on_serve`` before the source is touched (a retry after its fault
        is safe), the poisoning after (into ``out`` itself, the trainer's
        staging; else into a copy). A source is not thread-safe: with
        prefetch on, this Trainer's worker is its only server while a
        production is in flight."""
        if self.chaos is not None:
            self.chaos.on_serve(serve)
            if self._elastic is not None and self.chaos.take_return(serve):
                # return@serve: the fleet grants capacity back; the board
                # write is atomic, so the prefetch worker may post it. The
                # grow waits for the controller's next poll
                self._elastic.open_rejoin_window(serve)
        if out is not None:
            b = self.buffer.next(out=out)
            if self.chaos is not None:
                self.chaos.poison_batch(out, serve, inplace=True)
            return b
        b = self.buffer.next_raw() if hasattr(self.buffer, "next_raw") else self.buffer.next()
        if self.chaos is not None:
            b = self.chaos.poison_batch(b, serve)
        return b

    def _serve_staged(self, serve: int) -> tuple[torch.Tensor, list[Any]]:
        """The worker's serve of a source that fills an array handed in,
        into the next of two page-locked staging tensors once the copy out
        of its last fill is done: ``(tensor, its slot)``."""
        if not self._staging:
            pin = self.device.type == "cuda"
            self._staging = [[torch.empty(self.buffer.batch_shape, dtype=torch.float32,
                                          pin_memory=pin), None] for _ in range(2)]
        self._staging_turn ^= 1
        slot = self._staging[self._staging_turn]
        if slot[1] is not None:
            slot[1].synchronize()
        self._serve_once(serve, out=slot[0].numpy())
        return slot[0], slot

    # --- the batch: inline, or one deep on the prefetch worker --------------

    def _reserve_ticket(self) -> int | None:
        """The next launch slot (``None`` without a sequencer: one rank, or
        prefetch off, where one thread launches everything)."""
        return None if self._sequencer is None else self._sequencer.reserve()

    def _launch_turn(self, ticket: int | None):
        """Run launches in ``ticket``'s turn (nothing to wait for without
        one)."""
        return contextlib.nullcontext() if ticket is None else self._sequencer.turn(ticket)

    def _produce_batch(self, ticket: int | None = None, after=None):
        """Serve the next batch, keep this rank's rows, copy them to the
        device and upload the scale: ``(batch, scale, ready)``. On the
        prefetch worker (the whole production in ``ticket``'s turn) on the
        card, the launches go on the worker's stream after the event
        ``after`` (the work queued before the step that precedes this
        production) and ``ready`` is an event recorded after the copy;
        inline, ``ready`` is ``None``. Under ``cfg.harvest_timeout_s`` the
        serve runs under the watchdog, whose thread launches on this
        thread's stream."""
        worker = after is not None
        with self._launch_turn(ticket), contextlib.ExitStack() as ctx:
            if worker:
                ctx.enter_context(torch.cuda.device(self.device))
                ctx.enter_context(torch.cuda.stream(self._copy_stream))
                self._copy_stream.wait_event(after)
            staged = worker and self._serves_into
            serve = self._take_serve_index()
            fn = self._serve_staged if staged else self._serve_once
            out = fn(serve) if self._watchdog is None else self._watchdog.call(lambda: fn(serve))
            b, slot = out if staged else (out, None)
            if self._obs is not None:
                # one host-to-device batch upload a production (a batch
                # already on the device is still the serve path's, counted)
                self._obs.registry.count("comm/h2d_transfers")
            if self.mesh is not None and not getattr(self.buffer, "serves_local_rows", False):
                # this rank's rows of the global batch
                rows = b.shape[0] // self.mesh.data_size
                b = b[self.mesh.data_rank * rows:(self.mesh.data_rank + 1) * rows]
            batch = to_device(b, self.device)
            scale = self._device_scale()
            ready = None
            if worker:
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            if slot is not None:
                slot[1] = ready
        return batch, scale, ready

    def _stream_mark(self):
        """An event after the work queued so far on the step's stream
        (``None`` off the card)."""
        if self._copy_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _submit_prefetch(self, after=None) -> None:
        """Start producing the next batch on the worker, its launches after
        the event ``after``. The stream's state is taken first: a save
        while that batch is in flight records the position before it (the
        buffer is quiescent here)."""
        if hasattr(self.buffer, "state_dict"):
            self._buffer_snapshot = self.buffer.state_dict()
        ticket = self._reserve_ticket()
        try:
            self._pending = self._prefetch_pool.submit(self._produce_batch, ticket, after)
        except BaseException:
            if ticket is not None:
                self._sequencer.skip(ticket)    # an unused slot would stall every later turn
            raise

    def _next_batch(self) -> tuple[torch.Tensor, torch.Tensor, int | None, Any]:
        """``(batch, scale, ticket, after)``: the next batch on the device
        and its scale (raw rows from ``next_raw`` when the source has it,
        scaled in the step, else ``next()``), the launch slot of the step
        that trains on it, and the event the next production waits for
        (the work queued before that step). A batch already on the device
        is not copied. With prefetch on, the batch comes from the worker;
        :meth:`step` submits the next production once its launches are
        queued."""
        if self._prefetch_pool is None:
            batch, scale, _ = self._produce_batch()
            return batch, scale, self._reserve_ticket(), None
        if self._pending is None:
            self._submit_prefetch(self._stream_mark())
        batch, scale, ready = self._pending.result()
        self._pending = self._buffer_snapshot = None
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            # made on the worker's stream, used on the step's
            batch.record_stream(cur)
            scale.record_stream(cur)
        return batch, scale, self._reserve_ticket(), self._stream_mark()

    def _drain_prefetch(self, discard: bool = False) -> None:
        """Wait for the production in flight, so that the buffer is
        quiescent (a save, a restore); ``discard`` also drops its batch
        (the stream it came from is being rewound). A failure of that
        speculative batch is swallowed here and raised again when a step
        consumes it. Unlike the JAX trainer's, the drain never cancels a
        production that has not started: whether it has started depends on
        thread timing, and a source's serves must be the same on every
        rank and in every run."""
        if self._pending is None:
            return
        try:
            self._pending.exception()
        finally:
            if discard:
                self._pending = self._buffer_snapshot = None

    def step(self, full_metrics: bool = True) -> dict[str, Any]:
        """One optimizer step; returns device-resident metrics (no sync).
        ``full_metrics=False`` runs the bare variant (no l0/EV metrics).
        The update writes in place into a state this trainer made (see
        :func:`make_step_body`); a ``state`` passed at construction is
        copied by the first step instead."""
        key = variant_for_step(self.cfg, self._host_step, full_metrics)
        fn = self._step_fns.get(key)
        if fn is None:
            fn = self._step_fns[key] = make_step_body(
                self.cfg, self.opt, with_metrics=key[0], aux_on=key[1], mask_refresh=key[2],
                mesh=self.mesh)
        if self._obs is None:
            batch, scale, ticket, after = self._next_batch()
        else:
            # the loop blocked on the next batch: with prefetch on, what of
            # the serve the step did not hide (the refill bubble)
            t_wait = time.perf_counter_ns()
            with self._obs.tracer.span("refill_wait"):
                batch, scale, ticket, after = self._next_batch()
            self._obs.add_blocked_ns(time.perf_counter_ns() - t_wait)
        n_resampled = None
        with self._launch_turn(ticket):
            if resample_due(self.cfg, self._host_step):
                if self._resample_fn is None:
                    self._resample_fn = resample.make_resample_fn(self.cfg, self.mesh)
                gen = resample.resample_generator(self.cfg, self._host_step, self.device)
                self.state, n_resampled = self._resample_fn(self.state, batch, scale, gen)
            if self._obs is None:
                self.state, metrics = fn(self.state, batch, scale, donate=self._owns_state)
            else:
                with self._obs.tracer.span("step", step=self._host_step):
                    mark = None if key in self._comm_accounted else self._obs.comm_mark()
                    self.state, metrics = fn(self.state, batch, scale, donate=self._owns_state)
                    if mark is not None:
                        # each variant's collectives, as its first step counted them
                        self._obs.account_comm(mark)
                        self._comm_accounted.add(key)
        self._owns_state = True
        if n_resampled is not None:
            metrics["resampled"] = n_resampled
        self._host_step += 1
        # the next production, its slot after the step's; train() serves
        # nothing past its last step
        if self._prefetch_pool is not None and (self._prefetch_end is None
                                                or self._host_step < self._prefetch_end):
            self._submit_prefetch(after)
        return metrics

    def log(self, metrics: dict[str, Any], step: int) -> None:
        """Log the step's scalars; under the paged harvest also
        ``harvest/padding_efficiency``, the real-token share of everything
        harvested so far (padded runs log the reference's scalars only)."""
        if self.logger is not None and multihost.is_primary():
            scalars = expand_metrics(metrics, self.cfg.n_sources)
            scalars.update(self.resilience.snapshot())
            eff = getattr(self.buffer, "padding_efficiency", None)
            eff = eff() if callable(eff) else None
            if eff is not None:
                scalars["harvest/padding_efficiency"] = eff
            if self._obs is not None:
                scalars.update(self._obs.registry.snapshot())
            self.logger.log(scalars, step)

    # --- divergence guard + rollback (cfg.guard_loss) -----------------------

    def _agreed(self, flag: bool, op=dist.ReduceOp.MAX) -> bool:
        """``flag`` as every rank of the grid decides it (the OR under
        ``MAX``, the AND under ``MIN``); ``flag`` itself off a grid."""
        if self.mesh is None:
            return flag
        t = torch.full((1,), int(flag), dtype=torch.int32, device=self.device)
        with self._launch_turn(self._reserve_ticket()):
            return bool(coll.all_reduce_(t, self.mesh.world_group, op)[0])

    def _loss_diverged(self, loss_val: float) -> bool:
        """Divergence test on the loss the log step already fetched (no
        extra host sync): a non-finite loss always diverges; a finite one
        when it passes ``cfg.loss_spike_factor`` × the last healthy logged
        loss (none right after a start or a rollback). On a grid the loss
        is global, and the verdict is agreed over every rank besides."""
        ref = self._loss_ref
        diverged = not math.isfinite(loss_val) or (
            ref is not None and loss_val > self.cfg.loss_spike_factor * max(ref, 1e-12))
        diverged = self._agreed(diverged)
        if not diverged:
            self._loss_ref = loss_val
        return diverged

    def _params_finite(self) -> bool:
        """Every param finite, on every rank's shards: a device sync, made
        only inside a rollback."""
        ok = all(bool(torch.isfinite(v.float()).all()) for v in self.state.params.values())
        return self._agreed(ok, dist.ReduceOp.MIN)

    def _rollback(self, detect_step: int) -> None:
        """Restore the newest intact save whose params are finite (the
        newest may hold the poisoned state when the fault landed just
        before it), delete the saves after it, and consume unserved the
        serves up to ``detect_step``, so the retrained stretch runs on data
        past the fault. At most ``cfg.max_rollbacks`` times a Trainer, then
        :class:`RuntimeError`."""
        cfg = self.cfg
        self._rollbacks += 1
        if self._rollbacks > cfg.max_rollbacks:
            raise RuntimeError(
                f"loss diverged at step {detect_step} and the rollback budget "
                f"(max_rollbacks={cfg.max_rollbacks}) is exhausted; aborting. resilience "
                f"counters: {self.resilience.snapshot()}")
        if self.checkpointer is None:
            raise RuntimeError(f"loss diverged at step {detect_step} but the trainer has no "
                               "checkpointer to roll back to")
        self.resilience.bump("rollbacks")
        print(f"[crosscoder_tpu_torch] divergence at step {detect_step}: rolling back "
              f"({self._rollbacks}/{cfg.max_rollbacks})", file=sys.stderr, flush=True)
        meta = self.restore()
        cand_v = meta["save_version"]
        while not self._params_finite():
            self.resilience.bump("poisoned_save_skips")
            vdir = self.checkpointer.save_dir
            older = sorted(s for s in self.checkpointer.complete_saves(vdir) if s < cand_v)
            restored = False
            while older and not restored:
                cand_v = older.pop()
                if self.mesh is not None:
                    # every rank tries the same save, and only one all verify
                    cand_v = self.checkpointer._agree_min(cand_v, self.mesh, self.device)
                    if not self._agreed(self.checkpointer.verify_save(vdir, cand_v),
                                        dist.ReduceOp.MIN):
                        older = [s for s in older if s < cand_v]
                        continue
                try:
                    meta = self.restore(version_dir=vdir, save=cand_v)
                    restored = True
                except (ValueError, FileNotFoundError):
                    continue
            if not restored:
                raise RuntimeError(f"divergence rollback found no intact save with finite "
                                   f"params under {vdir}; aborting")
        # saves newer than the restored one may hold the state it escaped
        self.checkpointer.discard_saves_after(self.checkpointer.save_dir, cand_v)
        n_skip = max(0, detect_step + 1 - self.step_counter)
        to_serve = n_skip
        if to_serve and self._pending is not None:
            # a stream the restore did not rewind: the batch in flight is
            # the first of the serves to skip (raising now if it failed)
            self._pending.result()
            self._pending = self._buffer_snapshot = None
            to_serve -= 1
        for _ in range(to_serve):
            self._serve_once(self._take_serve_index())
        if n_skip:
            self.resilience.bump("skipped_batches", n_skip)
        self._loss_ref = None
        print(f"[crosscoder_tpu_torch] rolled back to step {self.step_counter} (save "
              f"{cand_v}), skipped {n_skip} poisoned batches", file=sys.stderr, flush=True)

    # --- elastic re-mesh (cfg.elastic) ----------------------------------------

    def _remesh_and_resume(self, cause: BaseException) -> None:
        """Survivor recovery: quiesce every consumer of the dying world,
        shrink it to the coordinator host's ranks, rebuild what the grid
        shaped, reshard the buffer and restore the newest verified save. On
        a rank that cannot survive the shrink raises
        :class:`~crosscoder_tpu_torch.resilience.elastic.PeerLoss`, which ends
        the run there. The recovery's wall time accumulates in
        ``resilience/remesh_ms``; :attr:`last_remesh` records the step, the
        save, the epoch and the time."""
        t0 = time.perf_counter()
        with trace.span("remesh"):
            print(f"[crosscoder_tpu_torch] elastic: peer loss confirmed "
                  f"({type(cause).__name__}); re-meshing over survivors", flush=True,
                  file=sys.stderr)
            # 1. quiesce. Tickets of the dying world first: a worker parked in
            #    a turn that never comes would wedge the drain behind it
            if self._sequencer is not None:
                self._sequencer.invalidate()
            with contextlib.suppress(Exception):     # its batch belongs to the dead world
                self._drain_prefetch(discard=True)
            self._pending = self._buffer_snapshot = None
            if hasattr(self.buffer, "prepare_reshard"):
                self.buffer.prepare_reshard()
            if self.checkpointer is not None:
                try:
                    self.checkpointer.wait()    # land a background write
                except Exception as e:  # noqa: BLE001 — the restore picks a verified save
                    print(f"[crosscoder_tpu_torch] elastic: background save failed "
                          f"({type(e).__name__}: {e})"[:300], file=sys.stderr, flush=True)
            # 2. shrink: leave the old world, join the survivors' epoch. Its
            #    groups must be unreferenced first, so that leaving closes
            #    their connections (a survivor blocked on this rank in one of
            #    their collectives then fails at once, not at the bound)
            self._drop_grid()
            for exc in _chain(cause):
                traceback.clear_frames(exc.__traceback__)
            try:
                mesh = self._elastic.shrink()
            except BaseException:
                self._world_lost = True
                raise
            # 3. what the old grid shaped, then the state from the newest save
            self._rebuild_for_mesh(mesh)
            if hasattr(self.buffer, "reshard"):
                # refill=False: the restore replays the save's stream position
                self.buffer.reshard(mesh, refill=False)
            meta = self.restore()
        ms = 1000 * (time.perf_counter() - t0)
        self.last_remesh = {"step": int(meta.get("step", -1)),
                            "save": int(meta.get("save_version", -1)),
                            "epoch": self._elastic.epoch(), "remesh_ms": int(ms)}
        self.resilience.bump("remesh_ms", int(ms))
        # the dwell clock: no grow within cfg.elastic_dwell_steps of this step
        self._elastic.note_remesh(self._host_step)
        print(f"[crosscoder_tpu_torch] elastic: resumed at step {self._host_step} on a "
              f"{mesh.data_size} x {mesh.model_size} grid ({ms:.0f} ms recovery)", flush=True,
              file=sys.stderr)

    def _grow_and_resume(self, step: int) -> None:
        """Scale-up at a step boundary: the shrunk survivors admit their
        debounced candidates, write the boundary save (state and stream
        position at exactly this step), re-form the wider world, and every
        member, survivors included, restores that save. No step is lost,
        and the grown world's steps are bitwise a clean start's at the wide
        shape from the same save. A failed rendezvous falls back to the
        narrow world, which restores the same save and trains on.

        The batch in flight on the prefetch worker is drained, not
        dropped: the save records the stream as it stood before it, so the
        restored stream serves it again (the JAX trainer drops it). The
        wall time accumulates in ``resilience/grow_ms``; :attr:`last_grow`
        records JAX's keys."""
        t0 = time.perf_counter()
        with trace.span("grow"):
            print(f"[crosscoder_tpu_torch] elastic: rejoin candidates debounced; growing at "
                  f"step {step}", flush=True, file=sys.stderr)
            # 1. quiesce: the tickets first (nothing else launches now), then
            #    the production in flight and the refill
            if self._sequencer is not None:
                self._sequencer.invalidate()
            with contextlib.suppress(Exception):    # a failed batch is served again
                self._drain_prefetch()
            self._quiesce_refill()
            # 2. the boundary save, landed: the joiners' hydration point
            self.save()
            self.checkpointer.wait()
            self._pending = self._buffer_snapshot = None
            boundary = self.checkpointer.save_version - 1
            vdir = str(self.checkpointer.save_dir)
            if hasattr(self.buffer, "prepare_reshard"):
                self.buffer.prepare_reshard()
            # 3. admit and re-form the wider world (the narrow one on a
            #    failed rendezvous); the old grid's groups unreferenced first
            self._drop_grid()
            mesh, admit = self._elastic.grow(step, save_version=boundary, version_dir=vdir,
                                             save_step=step)
            # 4. the new grid's pieces, then the boundary save the admit record
            #    names (rank 0's, on every survivor) on the new world
            rec = self._elastic.last_admit
            vdir, boundary = rec["version_dir"], int(rec["save"])
            self._rebuild_for_mesh(mesh)
            if hasattr(self.buffer, "reshard"):
                self.buffer.reshard(mesh, refill=False)
            meta = self.restore(version_dir=vdir, save=boundary)
            if admit is not None and not multihost.probe_liveness(
                    f"r{int(admit['epoch'])}", timeout_s=120.0):
                # the hydration barrier: nobody trains before every member has
                # restored (a joiner still building would cost a suspect)
                print("[crosscoder_tpu_torch] elastic: hydration barrier timed out; training "
                      "on (the probe path will catch a dead joiner)", flush=True,
                      file=sys.stderr)
        ms = 1000 * (time.perf_counter() - t0)
        self._elastic.note_remesh(self._host_step)
        self.last_grow = {"step": int(meta.get("step", -1)), "save": boundary,
                          "version_dir": vdir, "epoch": self._elastic.epoch(),
                          "grow_ms": int(ms), "grown": admit is not None,
                          "n_data": mesh.data_size}
        self.resilience.bump("grow_ms", int(ms))
        print(f"[crosscoder_tpu_torch] elastic: resumed at step {self._host_step} on a "
              f"{mesh.data_size} x {mesh.model_size} grid ({ms:.0f} ms grow recovery)",
              flush=True, file=sys.stderr)

    def _drop_grid(self) -> None:
        """Let go of everything the old grid shaped, its groups with it:
        the grid, the step bodies and the resample fn, the telemetry's
        grid, the launch sequencer and the state (restored from a save)."""
        self.mesh = None
        self.state = None
        self._step_fns = {}
        self._resample_fn = None
        self._comm_accounted = set()
        if self._obs is not None:
            self._obs.mesh = None
        if self._sequencer is not None:
            self._sequencer.invalidate()
        self._sequencer = None

    def _rebuild_for_mesh(self, mesh: mesh_lib.Mesh) -> None:
        """Point every grid-coupled piece at ``mesh`` (the step bodies and
        the resample fn are rebuilt lazily), with a launch sequencer only
        where the new world has more than one rank."""
        _check_mesh(self.cfg, mesh)
        self.mesh = mesh
        self._host_step = 0
        if self._obs is not None:
            self._obs.mesh = mesh
        if self.cfg.prefetch and multihost.needs_launch_tickets():
            self._sequencer = pipeline.LaunchSequencer()

    def train(self, num_steps: int | None = None) -> dict[str, float]:
        """Run to ``num_steps`` (default ``total_steps``): log every
        ``log_every`` steps with ``step_time_ms`` (mean since the last log,
        synced at log points only), save in the background every
        ``save_every`` steps, then save and close. A SIGTERM ends the loop
        after the current step. Under ``cfg.guard_loss`` a first save
        (when none was made) gives the guard a state to roll back to, and
        a diverged log step rolls back (:meth:`_rollback`) and re-enters
        the loop at the restored step. Under ``cfg.elastic`` a liveness probe
        runs before each step at the stop-poll cadence, and a peer loss (the
        probe's, or an exception the controller confirms) re-meshes and
        re-enters the loop at the restored step; under ``cfg.elastic_grow``
        a grow the controller finds ready after the probe does the same
        (:meth:`_grow_and_resume`), a profiler window in capture stopped
        first.

        Under ``cfg.obs`` each log line carries the registry's ``perf/*``
        and ``comm/*`` keys, ``perf/refill_bubble_frac`` (the share of the
        log interval's wall time the loop spent blocked on the next batch)
        and ``perf/step_wall_ms``. A profiler window
        (:class:`~crosscoder_tpu_torch.obs.profiler.ProfilerWindow`) runs when
        the plane, ``cfg.profile_steps`` or ``cfg.profile_dir`` asks for one,
        with SIGUSR1 installed on the main thread; a rollback and the loop's
        exit end a window in capture."""
        num_steps = self.total_steps if num_steps is None else num_steps
        guard = self.cfg.guard_loss
        metrics: dict[str, Any] = {}
        stop = False
        prev_handler = None
        obs = self._obs
        profiler = None
        if obs is not None or self.cfg.profile_dir or self.cfg.profile_steps:
            from crosscoder_tpu_torch.obs.profiler import ProfilerWindow

            profiler = ProfilerWindow(self.cfg, registry=obs.registry if obs is not None else None,
                                      device=self.device)

        def on_sigterm(signum, frame):
            nonlocal stop
            if stop:             # a second signal: give control back and re-raise
                signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)
                return
            stop = True
            print("[crosscoder_tpu_torch] SIGTERM: stopping after this step, writing "
                  "checkpoint", file=sys.stderr, flush=True)

        multi_rank = self.mesh is not None and multihost.world_size() > 1

        def stop_agreed(i: int) -> bool:
            """The stop as every rank sees it: a SIGTERM may reach one rank
            only, and the save after the loop is a collective, so on more
            than one rank the flag is OR-reduced every
            ``cfg.stop_poll_every`` steps (the same steps on every rank)."""
            if not multi_rank:
                return stop
            if i % self.cfg.stop_poll_every:
                return False
            flag = torch.full((1,), int(stop), dtype=torch.int32, device=self.device)
            with self._launch_turn(self._reserve_ticket()):
                return bool(coll.all_reduce_(flag, self.mesh.world_group, dist.ReduceOp.MAX)[0])

        in_main_thread = threading.current_thread() is threading.main_thread()
        if in_main_thread:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
            if profiler is not None:
                profiler.install_sigusr1()      # kill -USR1 <pid>: a window from the next step
        self._prefetch_end = num_steps
        try:
            if guard and self.checkpointer is not None and self.checkpointer.save_version == 0:
                self.save()
            # one pass a training stretch: the whole run, or one more after
            # each rollback, from the restored step
            rolled_back = True
            while rolled_back:
                rolled_back = False
                start = self.step_counter
                last_t, last_i = time.perf_counter(), start
                if obs is not None:
                    obs.take_blocked_s()        # waits before a rollback are not this stretch's
                if profiler is not None:
                    profiler.begin_stretch(start)
                try:
                    for i in range(start, num_steps):
                        # the liveness probe: the same steps on every rank
                        if (self._elastic is not None and self._elastic.should_probe(i)
                                and not self._elastic.probe(i)):
                            raise PeerLoss(f"peer lost (liveness probe, step {i})")
                        # scale-up: the shrunk survivors poll the rejoin board;
                        # past the debounce and the dwell they grow at this
                        # boundary and re-enter the loop on the wider grid
                        if (self._elastic is not None and self.checkpointer is not None
                                and self._elastic.grow_ready(i)):
                            if profiler is not None:
                                profiler.stop_if_active()
                            self._grow_and_resume(i)
                            multi_rank = multihost.world_size() > 1
                            rolled_back = True
                            break
                        if stop_agreed(i):
                            break
                        if profiler is not None:
                            profiler.before_step(i)
                        metrics = self.step(full_metrics=(i % self.cfg.log_every == 0))
                        if profiler is not None:
                            profiler.after_step(i)
                        if i % self.cfg.log_every == 0:
                            loss_val = float(metrics["loss"])       # device sync
                            if obs is not None:
                                obs.registry.count("comm/d2h_transfers")
                            if guard and self._loss_diverged(loss_val):
                                if profiler is not None:
                                    profiler.stop_if_active()   # the next stretch may start one
                                self._rollback(i)
                                rolled_back = True
                                break
                            now = time.perf_counter()
                            metrics = dict(metrics)
                            metrics["step_time_ms"] = 1000 * (now - last_t) / max(i - last_i, 1)
                            if obs is not None:
                                reg = obs.registry
                                reg.gauge("perf/step_wall_ms", metrics["step_time_ms"])
                                reg.gauge("perf/refill_bubble_frac",
                                          min(1.0, obs.take_blocked_s() / max(now - last_t,
                                                                              1e-9)))
                            last_t, last_i = now, i
                            self.log(metrics, step=i)
                        if (i + 1) % self.cfg.save_every == 0:
                            self.save(background=True)
                except Exception as exc:
                    # a dying peer tearing a collective, or an ordinary error? A
                    # failed probe is already confirmed; anything else asks one
                    # more bounded barrier, and an unconfirmed error re-raises
                    if self._elastic is None or not (
                            isinstance(exc, PeerLoss) or self._elastic.confirm_peer_loss(exc)):
                        raise
                    if profiler is not None:
                        profiler.stop_if_active()
                    self._remesh_and_resume(exc)
                    # the world changed shape: the stop poll reads it again
                    multi_rank = multihost.world_size() > 1
                    rolled_back = True
        finally:
            self._prefetch_end = None
            if in_main_thread:
                signal.signal(signal.SIGTERM, prev_handler or signal.SIG_DFL)
                if profiler is not None:
                    profiler.uninstall_sigusr1()
            if profiler is not None:
                profiler.stop_if_active()
            try:
                if not self._world_lost:    # a lost rank's groups are gone
                    self.save(background=True)
            finally:
                self.close()
        return expand_metrics(metrics, self.cfg.n_sources) if metrics else {}

    def close(self) -> None:
        """Stop the prefetch worker, land a background save, close the
        logger and the source, then write the trace and give the
        process-global tracer back. Idempotent."""
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown(wait=True)
            self._prefetch_pool = None
            self._pending = self._buffer_snapshot = None
        if self.checkpointer is not None:
            self.checkpointer.wait()
        if self.logger is not None:
            self.logger.close()
            self.logger = None
        if hasattr(self.buffer, "close"):
            self.buffer.close()
        if self._watchdog is not None:
            self._watchdog.close()
            self._watchdog = None
        if self._obs is not None:
            self._obs.close()
            self._obs = None

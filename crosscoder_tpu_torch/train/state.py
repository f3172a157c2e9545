"""Train state and optimizer, ported from :mod:`crosscoder_tpu.train.state`.

:class:`TrainState` holds the f32 (or bf16, ``cfg.master_dtype``) master
params, the optimizer state, the step counter and the non-optimizer state
``aux`` (AuxK: ``steps_since_fired`` [d_hidden] int32, plus the cached
``dead_mask`` when ``cfg.aux_mask_every != 1``; the quantized exchange's
residuals ``quant_ef``, a dict of ``[n_data, L]`` f32, under
``cfg.quant_grads`` on a mesh).

:class:`Optimizer` reproduces the JAX package's ``make_optimizer`` (optax
``clip_by_global_norm(grad_clip)`` → ``scale_by_adam(b1, b2, eps=1e-8)``
→ ``scale_by_learning_rate(lr)``) op for op: the clip scales by
``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon (where
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and would drift
the trajectory); the bias corrections use ``1 - b**t`` in f32; the update
is ``-lr(count) · m̂ / (sqrt(v̂) + eps)``. The global norm is a torch
reduction; the clip, Adam and the learning rate are one pass
(:func:`crosscoder_tpu_torch.ops.adam.adam_update`: O1 on the card), the
clip chosen on the device, so an update never syncs the host. With
``donate=True`` the pass writes params and moments in place, as the JAX
step's ``donate_argnums`` lets XLA do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.utils.device import resolve_device

Params = dict[str, torch.Tensor]


@dataclass
class AdamState:
    count: int                      # optimizer updates applied so far
    mu: Params
    nu: Params


@dataclass
class TrainState:
    params: Params
    opt_state: AdamState
    step: int
    aux: dict[str, torch.Tensor] | None = None


class Optimizer:
    """Global-norm clip → Adam → ``-lr(count)``, on dicts of tensors."""

    def __init__(self, cfg: CrossCoderConfig, lr_fn: Callable[[int], Any]) -> None:
        self.max_norm = float(cfg.grad_clip)
        self.b1, self.b2, self.eps = float(cfg.beta1), float(cfg.beta2), 1e-8
        self.lr_fn = lr_fn
        self.shard_sources = cfg.shard_sources      # the rules the mesh shards by

    def init(self, params: Params) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    @staticmethod
    def global_norm(grads: Params, mesh=None, shard_sources: bool = False) -> torch.Tensor:
        """The f32 global norm of ``grads`` on their device: the sum of
        squares over the leaves in sorted-name order, as optax.global_norm
        walks a dict. Under a ``mesh`` (``grads`` this rank's shards) the
        sums of the leaves sharded over ``model`` (by the rules
        ``shard_sources`` picks) are summed over it first, in one
        all-reduce; a replicated leaf counts once."""
        names = sorted(grads)
        sq = {k: torch.sum(torch.square(grads[k].float())) for k in names}
        if mesh is not None:
            from crosscoder_tpu_torch.parallel import collectives as coll
            from crosscoder_tpu_torch.parallel.mesh import param_spec, shard_dim

            sharded = [k for k in names
                       if shard_dim(param_spec(k, shard_sources)) is not None]
            if sharded:
                sums = coll.all_reduce_(torch.stack([sq[k] for k in sharded]), mesh.model_group)
                sq.update(zip(sharded, sums.unbind(0)))
        return torch.sqrt(sum(sq[k] for k in names))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params, *, donate: bool = False,
               mesh=None, norm: torch.Tensor | None = None) -> tuple[Params, AdamState]:
        """``(new params, new state)``. ``donate=True`` writes them into
        ``params``, ``state.mu`` and ``state.nu`` (the caller gives those
        up); otherwise the inputs stay intact. Under a ``mesh`` every
        argument is this rank's shards and the clip reads the global norm
        (:meth:`global_norm`). ``norm``: the clip's norm when the caller
        has it; an ``[N]`` vector updates a fleet cohort, every leaf N
        tenants' leaves stacked on its leading axis, each tenant clipped
        by its own norm (one O1 launch), its Adam count shared."""
        if norm is None:
            norm = self.global_norm(grads, mesh, self.shard_sources)
        t = state.count + 1
        bc1 = np.float32(1.0) - np.float32(self.b1) ** np.float32(t)
        bc2 = np.float32(1.0) - np.float32(self.b2) ** np.float32(t)
        step_size = -np.float32(self.lr_fn(state.count))
        if donate:
            new, out = (params, state.mu, state.nu), None
        else:
            new = out = tuple({k: torch.empty_like(v) for k, v in d.items()}
                              for d in (params, state.mu, state.nu))
        adam.adam_update(params, grads, state.mu, state.nu, norm, max_norm=self.max_norm,
                         b1=self.b1, b2=self.b2, eps=self.eps, bc1=float(bc1), bc2=float(bc2),
                         step_size=float(step_size), out=out)
        return new[0], AdamState(t, new[1], new[2])


def resolve_data_axis(cfg: CrossCoderConfig) -> int:
    """The ``data``-axis width a cfg-built mesh has over the joined
    process group (one rank a device): the width of state pieces whose
    shape depends on it (the ``quant_grads`` residuals)."""
    if cfg.data_axis_size > 0:
        return cfg.data_axis_size
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    return max(1, world // max(1, cfg.model_axis_size))


def init_train_state(cfg: CrossCoderConfig, opt: Optimizer, *, seed: int | None = None,
                     device=None, n_data: int | None = None) -> TrainState:
    """Fresh state: params from :func:`crosscoder.init_params` in
    ``cfg.master_dtype``, zero Adam moments, step 0, and the AuxK tracker
    (every latent "recently fired"); with ``cfg.quant_grads`` on a
    ``data`` axis wider than 1 (``n_data``, default
    :func:`resolve_data_axis`) the exchange's zero residuals
    ``aux["quant_ef"]``, ``[n_data, L]`` a param. Runs on ``cuda`` unless
    ``device`` names another device."""
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.master_dtype == "fp32" else torch.bfloat16
    params = cc.init_params(cfg, seed=cfg.seed if seed is None else seed, device=dev,
                            dtype=dtype)
    aux = None
    if cfg.aux_k > 0 or cfg.resample_every > 0:
        aux = {"steps_since_fired": torch.zeros((cfg.dict_size,), dtype=torch.int32, device=dev)}
        if cfg.aux_mask_every != 1:
            aux["dead_mask"] = torch.zeros((cfg.dict_size,), dtype=torch.bool, device=dev)
    if cfg.quant_grads:
        nd = resolve_data_axis(cfg) if n_data is None else n_data
        if nd > 1:
            from crosscoder_tpu_torch.parallel import quant_ar

            aux = dict(aux or {})
            aux["quant_ef"] = quant_ar.ef_init(params, nd, cfg.quant_block)
    return TrainState(params=params, opt_state=opt.init(params), step=0, aux=aux)

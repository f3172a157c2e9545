"""Train state and optimizer, ported from :mod:`crosscoder_tpu.train.state`.

:class:`TrainState` holds the f32 (or bf16, ``cfg.master_dtype``) master
params, the optimizer state, the step counter and the non-optimizer state
``aux`` (AuxK: ``steps_since_fired`` [d_hidden] int32, plus the cached
``dead_mask`` when ``cfg.aux_mask_every != 1``).

:class:`Optimizer` reproduces the JAX package's ``make_optimizer`` (optax
``clip_by_global_norm(grad_clip)`` → ``scale_by_adam(b1, b2, eps=1e-8)``
→ ``scale_by_learning_rate(lr)``) op for op: the clip scales by
``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon (where
``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and would drift
the trajectory); the bias corrections use ``1 - b**t`` in f32; the update
is ``-lr(count) · m̂ / (sqrt(v̂) + eps)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
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

    def init(self, params: Params) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    def clip(self, grads: Params) -> Params:
        # sum of squares over the leaves in sorted-name order, as
        # optax.global_norm walks a dict
        norm = torch.sqrt(sum(torch.sum(torch.square(grads[k].float())) for k in sorted(grads)))
        if bool(norm < self.max_norm):
            return grads
        return {k: (g / norm.to(g.dtype)) * self.max_norm for k, g in grads.items()}

    @torch.no_grad()
    def update(self, grads: Params, state: AdamState, params: Params) -> tuple[Params, AdamState]:
        """``(new params, new state)``."""
        grads = self.clip(grads)
        t = state.count + 1
        bc1 = np.float32(1.0) - np.float32(self.b1) ** np.float32(t)
        bc2 = np.float32(1.0) - np.float32(self.b2) ** np.float32(t)
        step_size = -np.float32(self.lr_fn(state.count))
        new_params, mu, nu = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1 - self.b2) * torch.square(g) + self.b2 * state.nu[k]
            m_hat = mu[k] / torch.tensor(bc1, dtype=mu[k].dtype, device=g.device)
            v_hat = nu[k] / torch.tensor(bc2, dtype=nu[k].dtype, device=g.device)
            upd = m_hat / (torch.sqrt(v_hat) + self.eps)
            upd = torch.tensor(step_size, dtype=upd.dtype, device=g.device) * upd
            new_params[k] = (params[k] + upd).to(params[k].dtype)
        return new_params, AdamState(t, mu, nu)


def init_train_state(cfg: CrossCoderConfig, opt: Optimizer, *, seed: int | None = None,
                     device=None) -> TrainState:
    """Fresh state: params from :func:`crosscoder.init_params` in
    ``cfg.master_dtype``, zero Adam moments, step 0, and the AuxK tracker
    (every latent "recently fired"). Runs on ``cuda`` unless ``device``
    names another device."""
    dev = resolve_device(device)
    dtype = torch.float32 if cfg.master_dtype == "fp32" else torch.bfloat16
    params = cc.init_params(cfg, seed=cfg.seed if seed is None else seed, device=dev,
                            dtype=dtype)
    aux = None
    if cfg.aux_k > 0 or cfg.resample_every > 0:
        aux = {"steps_since_fired": torch.zeros((cfg.dict_size,), dtype=torch.int32, device=dev)}
        if cfg.aux_mask_every != 1:
            aux["dead_mask"] = torch.zeros((cfg.dict_size,), dtype=torch.bool, device=dev)
    return TrainState(params=params, opt_state=opt.init(params), step=0, aux=aux)

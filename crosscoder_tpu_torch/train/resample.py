"""Dead-latent resampling (``cfg.resample_every``), ported from
:mod:`crosscoder_tpu.train.resample`.

Bricken et al. 2023 ("Towards Monosemanticity", neuron resampling)
re-initialize dead latents from the examples the dictionary reconstructs
worst. On the port's :class:`~crosscoder_tpu_torch.train.state.TrainState`:

1. deadness: ``steps_since_fired >= cfg.resample_threshold_steps``;
2. one batch row per latent, sampled with probability ∝ (row L2
   residual)² (:func:`sample_rows`, from an explicit
   :class:`torch.Generator`: :func:`resample_generator` seeds it from
   ``cfg.seed + 0x5EED`` and the host step, as the JAX trainer folds the
   step into its key);
3. dead decoder rows := that row's residual direction, normalized per
   (latent, source) to ``dec_init_norm``;
4. dead encoder columns := the same direction scaled to
   ``cfg.resample_enc_scale × mean alive encoder norm``;
5. ``b_enc[dead] := 0``; the Adam moments of every edited slice := 0;
6. ``steps_since_fired[dead] := 0``.

The sampling and the edit are apart (:func:`resample_rows` takes the row
indices), so a caller can hand both packages the same rows: JAX's
``jax.random.categorical`` cannot be matched draw for draw. Plain
PyTorch: the JAX package runs it as one jitted program, with no Pallas
kernel; the TopK forward inside runs the mask kernels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.train.state import AdamState, TrainState
from crosscoder_tpu_torch.utils.dtypes import dtype_of

_DICT_AXIS = {"W_enc": 2, "W_dec": 0, "b_enc": 0}


def _zero_dead_rows(tree: dict[str, torch.Tensor], dead: torch.Tensor) -> dict[str, torch.Tensor]:
    """The moment slices of the resampled latents set to 0 (``W_enc``
    along its last axis, ``W_dec`` and ``b_enc`` along their first)."""
    out = dict(tree)
    for k, ax in _DICT_AXIS.items():
        leaf = tree[k]
        shape = [1] * leaf.ndim
        shape[ax] = leaf.shape[ax]
        out[k] = torch.where(dead.reshape(shape), torch.zeros((), dtype=leaf.dtype,
                                                              device=leaf.device), leaf)
    return out


def resample_generator(cfg: CrossCoderConfig, host_step: int, device) -> torch.Generator:
    """The sampling generator of the resample at ``host_step``: seeded
    from ``cfg.seed + 0x5EED`` and the step."""
    seed = np.random.SeedSequence([cfg.seed + 0x5EED, int(host_step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed >> np.uint64(1)))


@torch.no_grad()
def residuals(cfg: CrossCoderConfig, state: TrainState, batch: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``x − forward(x)`` in f32, ``[B, n, d]``, with ``x = batch · scale``
    per source and the params in the compute dtype."""
    x = batch.float() * scale[None, :, None]
    dt = dtype_of(cfg.enc_dtype)
    recon = cc.forward(cc.cast_params(state.params, dt), x.to(dt), cfg)
    return x - recon.float()


@torch.no_grad()
def sample_rows(e: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` batch rows drawn with replacement, row ``b`` with probability
    ∝ ``(Σ e[b]²)²`` (JAX's logits ``2·log(e2 + 1e-30)``)."""
    e2 = torch.square(e).sum(dim=(1, 2))
    logits = 2.0 * torch.log(e2 + 1e-30)
    probs = torch.softmax(logits.double(), dim=0)
    return torch.multinomial(probs, n, replacement=True, generator=generator)


@torch.no_grad()
def resample_rows(cfg: CrossCoderConfig, state: TrainState, e: torch.Tensor,
                  ridx: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
    """``(new state, number resampled)``: the dead latents re-initialized
    from the residual rows ``e[ridx]`` (``ridx [d_hidden]``, one row per
    latent). The state handed in is not modified."""
    params = state.params
    H = cfg.dict_size
    dirs = e[ridx.long()]                                          # [H, n, d]
    unit = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    dead = state.aux["steps_since_fired"] >= cfg.resample_threshold_steps
    W_dec = params["W_dec"].float()
    new_dec = torch.where(dead[:, None, None], unit * cfg.dec_init_norm, W_dec)
    W_enc = params["W_enc"].float()
    enc_norm = torch.sqrt(torch.square(W_enc).sum(dim=(0, 1)))     # [H]
    alive = ~dead
    n_alive = torch.clamp(alive.float().sum(), min=1.0)
    mean_alive = torch.where(alive, enc_norm, 0.0).sum() / n_alive
    flat_norm = torch.linalg.norm(dirs.reshape(H, -1), dim=-1)[:, None, None]
    enc_dirs = (dirs / (flat_norm + 1e-12)).permute(1, 2, 0)       # [n, d, H]
    new_enc = torch.where(dead[None, None, :], enc_dirs * cfg.resample_enc_scale * mean_alive,
                          W_enc)
    new_params = dict(params)
    new_params["W_dec"] = new_dec.to(params["W_dec"].dtype)
    new_params["W_enc"] = new_enc.to(params["W_enc"].dtype).contiguous()
    new_params["b_enc"] = torch.where(dead, torch.zeros((), dtype=params["b_enc"].dtype,
                                                        device=dead.device), params["b_enc"])
    opt = state.opt_state
    new_opt = AdamState(opt.count, _zero_dead_rows(opt.mu, dead), _zero_dead_rows(opt.nu, dead))
    new_aux = dict(state.aux)
    new_aux["steps_since_fired"] = torch.where(dead, 0, state.aux["steps_since_fired"]).to(
        torch.int32)
    return TrainState(new_params, new_opt, state.step, new_aux), dead.sum().to(torch.int32)


def make_resample_fn(cfg: CrossCoderConfig
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor, torch.Generator],
                                   tuple[TrainState, torch.Tensor]]:
    """``(state, batch, scale, generator) -> (state, n_resampled)``: the
    residuals, one sampled row per latent, the edit."""

    def resample(state, batch, scale, generator):
        e = residuals(cfg, state, batch, scale)
        return resample_rows(cfg, state, e, sample_rows(e, cfg.dict_size, generator))

    return resample

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

On a rank grid (``make_resample_fn(cfg, mesh)``; the JAX package's one
sharded program) every rank runs the grid's forward on its rows, gathers
the global batch's squared row errors over ``data`` and draws the same
rows from the same generator; each rank then edits its own shards of
``W_enc``, ``b_enc``, ``W_dec`` and their Adam moments from its slice of
the global ``steps_since_fired``, the rows' residuals gathered over
``data``, and the statistics over latents (the mean alive encoder norm)
or over sources (``shard_sources``: the norms over the whole ``(n, d)``
extent) summed over ``model``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.parallel import collectives as coll
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
              scale: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x − forward(x)`` in f32, ``[B, n, d]``, with ``x = batch · scale``
    per source and the params in the compute dtype. On a rank grid
    (``mesh``): this rank's rows through the grid's encode, selection and
    decode (:func:`crosscoder_tpu_torch.models.crosscoder.get_losses`'
    collectives); under ``shard_sources`` this rank's sources only."""
    x = batch.float() * scale[None, :, None]
    dt = dtype_of(cfg.enc_dtype)
    params = cc.cast_params(state.params, dt)
    src_group = None
    if mesh is not None and cfg.shard_sources:
        src_group = mesh.model_group
        x = x[..., mesh.source_slice(x.shape[-2]), :]
        mesh = mesh.dict_view()
    f = cc._activate(cc.pre_acts(params, x.to(dt), src_group), cfg, params, mesh)
    return x - cc.decode(params, f, mesh).float()


def _draw(e2: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    logits = 2.0 * torch.log(e2 + 1e-30)
    probs = torch.softmax(logits.double(), dim=0)
    return torch.multinomial(probs, n, replacement=True, generator=generator)


@torch.no_grad()
def sample_rows(e: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` batch rows drawn with replacement, row ``b`` with probability
    ∝ ``(Σ e[b]²)²`` (JAX's logits ``2·log(e2 + 1e-30)``)."""
    return _draw(torch.square(e).sum(dim=(1, 2)), n, generator)


@torch.no_grad()
def resample_rows(cfg: CrossCoderConfig, state: TrainState, e: torch.Tensor,
                  ridx: torch.Tensor, mesh=None) -> tuple[TrainState, torch.Tensor]:
    """``(new state, number resampled)``: the dead latents re-initialized
    from the residual rows ``e[ridx]`` (``ridx``: one row a latent). The
    state handed in is not modified. On a rank grid ``state`` is this
    rank's shards, ``ridx`` its latents' rows of the global batch ``e``
    (this rank's sources under ``shard_sources``), and the sums over the
    dictionary or the sources that the edit needs run over ``model``."""
    params = state.params
    H = ridx.shape[0]
    lat_group = src_group = None            # the latents' and the sources' split
    if mesh is not None:
        if cfg.shard_sources:
            src_group = mesh.model_group
        else:
            lat_group = mesh.model_group
    dirs = e[ridx.long()]                                          # [H, n, d]
    unit = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    dead = state.aux["steps_since_fired"] >= cfg.resample_threshold_steps
    W_dec = params["W_dec"].float()
    new_dec = torch.where(dead[:, None, None], unit * cfg.dec_init_norm, W_dec)
    W_enc = params["W_enc"].float()
    alive = ~dead
    enc_norm = torch.sqrt(coll.all_reduce_(torch.square(W_enc).sum(dim=(0, 1)), src_group))
    sums = coll.all_reduce_(torch.stack([torch.where(alive, enc_norm, 0.0).sum(),
                                         alive.float().sum()]), lat_group)
    mean_alive = sums[0] / torch.clamp(sums[1], min=1.0)             # over alive latents
    flat = dirs.reshape(H, -1)
    flat_norm = (torch.linalg.norm(flat, dim=-1) if src_group is None else
                 torch.sqrt(coll.all_reduce_(torch.square(flat).sum(dim=-1), src_group)))
    flat_norm = flat_norm[:, None, None]
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
    n = coll.all_reduce_(dead.sum().to(torch.int32), lat_group)
    return TrainState(new_params, new_opt, state.step, new_aux), n


def make_resample_fn(cfg: CrossCoderConfig, mesh=None
                     ) -> Callable[[TrainState, torch.Tensor, torch.Tensor, torch.Generator],
                                   tuple[TrainState, torch.Tensor]]:
    """``(state, batch, scale, generator) -> (state, n_resampled)``: the
    residuals, one sampled row per latent, the edit. On a rank grid
    (``mesh``) ``state`` is this rank's shards and ``batch`` its rows; every
    rank must call it, with a generator seeded alike."""

    def resample(state, batch, scale, generator):
        e = residuals(cfg, state, batch, scale)
        return resample_rows(cfg, state, e, sample_rows(e, cfg.dict_size, generator))

    def resample_mesh(state, batch, scale, generator):
        e = residuals(cfg, state, batch, scale, mesh)
        src_group = mesh.model_group if cfg.shard_sources else None
        e2 = coll.all_reduce_(torch.square(e).sum(dim=(1, 2)), src_group)
        ridx = _draw(coll.all_gather_cat(e2, 0, mesh.data_group), cfg.dict_size, generator)
        if not cfg.shard_sources:            # this rank's latents
            h = state.params["b_enc"].shape[0]
            ridx = ridx[mesh.model_rank * h:(mesh.model_rank + 1) * h]
        e_all = coll.all_gather_cat(e, 0, mesh.data_group)
        return resample_rows(cfg, state, e_all, ridx, mesh)

    return resample if mesh is None else resample_mesh

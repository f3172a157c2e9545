"""The crosscoder, ported from :mod:`crosscoder_tpu.models.crosscoder`.

Params keep the JAX package's leaf names and layout: ``W_enc [n, d_in,
d_hidden]``, ``W_dec [d_hidden, n, d_in]``, ``b_enc [d_hidden]``, ``b_dec
[n, d_in]``, where ``n`` is the source axis (models × hooked layers).
:func:`init_params` returns them as a dict of tensors; :class:`CrossCoder`
holds them as a trainable ``nn.Module``.

The loss surface (:func:`get_losses`, :func:`training_loss`) follows the
JAX package: summed-square-error L2 (mean over the batch), explained
variance overall and per source, decoder-norm-weighted L1, L0, and the
AuxK dead-latent loss. The TopK tiers resolve from ``cfg`` exactly as the
JAX gates do, with "kernel live" read as always true except for the
fused encoder, which only "on" takes (:func:`use_fused_encoder`). "The
mask" below is
the TopK mask kernel :func:`topk_pallas.topk_forward` picks for the
pre-activations: K5 (bf16 up to 2^16 wide), K6 (f32 that fits its
single-block gate) or K7 (wider rows, f32 or bf16):

- factored (:class:`_FactoredTopK`): the mask → K8 drain → k-row decode,
  backward through the dense matmuls;
- sparse step (:class:`_SparseTopKStep`, bare steps of ``sparse_bwd``):
  encode + the mask + K8 + decode in one autograd scope, backward through the
  K10 scatter (dW_dec, then dW_enc with db_enc riding a ones column);
- fused step (the same class with the K2 encoder→TopK forward, or K3's
  int8 block-scaled one under ``quant_encoder``);
- sparse from h (:class:`_SparseTopKFromH`, AuxK steps: h stays a
  differentiable residual for the aux ranking) and the aux product
  (:class:`_SparseAuxProduct`, dense forward, K10 backward);
- ``sparse_decode`` (:func:`sparse_topk_forward`): the selected set from
  the mask and K8, the values gathered from ``relu(h)`` (so the encoder
  gets its gradient through the gather), the decode through the k active
  rows (:class:`_SparseDecodeProduct`, dW_dec by the dense-scatter
  product).

On CPU tensors each kernel's plain version takes its place, as the JAX
package's interpret mode does. AuxK ranks dead latents exactly with
``torch.topk`` (JAX's ``aux_exact_rank=True``); the TPU path ranks them
with ``approx_max_k``. BatchTopK trains through the dense encode and the
K9 kernels (:mod:`crosscoder_tpu_torch.ops.topk_pallas`), or under
``fused_encoder='on'`` through :class:`_FusedBatchTopKEncode` (K4: the
encoder product and the global selection fused; the dense straight-through
backward), AuxK steps keeping the dense encode;
:func:`calibrate_batchtopk_threshold` gives its eval-mode threshold.
JumpReLU keeps an f32 ``log_theta [d_hidden]`` leaf beside the weights
(whatever their dtype) and, with ``cfg.l0_coeff > 0``, adds the L0
objective (:func:`crosscoder_tpu_torch.ops.activations.jumprelu_l0`) as
``l0_penalty``.

Matmuls sum in f32: from bf16 operands on the card through
``torch.mm(..., out_dtype=torch.float32)`` (tensor cores; the backward
rounds the f32 cotangent to bf16 first, as the TPU's default precision
does), elsewhere on f32 copies.
"""

from __future__ import annotations

import sys
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.ops import activations as act_ops
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import sparse_grad, topk_pallas
from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.dtypes import dtype_of

Params = dict[str, torch.Tensor]
_LOW = (torch.bfloat16, torch.float16)


class LossOutput(NamedTuple):
    """Loss surface of one batch; all f32."""

    l2_loss: torch.Tensor
    l1_loss: torch.Tensor
    l0_loss: torch.Tensor
    explained_variance: torch.Tensor                 # [batch]
    explained_variance_per_source: torch.Tensor      # [n_sources, batch]
    l0_penalty: torch.Tensor | float = 0.0           # jumprelu with l0_coeff > 0
    aux_loss: torch.Tensor | float = 0.0
    fired: torch.Tensor | None = None


def init_params(cfg: CrossCoderConfig, *, seed: int = 0, device=None,
                dtype: torch.dtype | None = None) -> Params:
    """Decoder rows standard-normal, rescaled to norm ``dec_init_norm`` per
    (latent, source); the encoder is the decoder's transpose; biases 0.
    Params are in ``dtype`` (default ``cfg.enc_dtype``); JumpReLU adds
    ``log_theta`` at ``log(cfg.jumprelu_theta)``, f32 whatever ``dtype``.
    Runs on ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d_in, d_hidden = cfg.n_sources, cfg.d_in, cfg.dict_size
    dtype = dtype_of(cfg.enc_dtype) if dtype is None else dtype
    w = torch.randn((d_hidden, n, d_in), generator=gen, device=dev)
    w = w / torch.linalg.norm(w, dim=-1, keepdim=True) * cfg.dec_init_norm
    params = {
        "W_dec": w.to(dtype),
        "W_enc": w.permute(1, 2, 0).to(dtype).contiguous(),
        "b_enc": torch.zeros((d_hidden,), dtype=dtype, device=dev),
        "b_dec": torch.zeros((n, d_in), dtype=dtype, device=dev),
    }
    if cfg.activation == "jumprelu":
        log_theta = torch.log(torch.tensor(cfg.jumprelu_theta, dtype=torch.float32))
        params["log_theta"] = torch.full((d_hidden,), float(log_theta), dtype=torch.float32,
                                         device=dev)
    return params


# ---------------------------------------------------------------------------
# f32-accumulating matmul


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in f32 and returned in f32."""
    if a.is_cuda and a.dtype in _LOW and b.dtype == a.dtype:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _cot(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The f32 cotangent as a matmul operand beside ``like``: rounded to
    its low-precision dtype on the card (tensor cores), kept f32 elsewhere."""
    return g.to(like.dtype) if g.is_cuda and like.dtype in _LOW else g


class _MatmulF32(torch.autograd.Function):
    """``a [M, K] @ b [K, N]`` → f32, gradients in each operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _mm32(_cot(g, b), b.t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _mm32(a.t(), _cot(g, a)).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _MatmulF32.apply(a, b)


def pre_acts(params: Mapping[str, torch.Tensor], x: torch.Tensor, src_group=None
             ) -> torch.Tensor:
    """Encoder pre-activations ``x @ W_enc + b_enc`` summed over sources:
    ``[B, n, d_in]`` → ``[B, d_hidden]``, f32 accumulation, result in
    ``x``'s dtype. ``src_group``: the ranks the sources are split over
    (``shard_sources``; ``x`` and ``W_enc`` this rank's sources): the f32
    partial products sum over it before ``b_enc`` (differentiably)."""
    W = params["W_enc"]
    lead = x.shape[:-2]
    h = matmul_f32(x.reshape(-1, W.shape[0] * W.shape[1]), W.reshape(-1, W.shape[2]))
    h = coll.sum_over(h, src_group)
    return (h + params["b_enc"].float()).to(x.dtype).reshape(*lead, W.shape[2])


def encode(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: CrossCoderConfig, *,
           apply_activation: bool = True) -> torch.Tensor:
    """Latent activations ``[B, d_hidden]`` (raw pre-activations with
    ``apply_activation=False``)."""
    h = pre_acts(params, x)
    return act_ops.apply(h, cfg, dict(params)) if apply_activation else h


@torch.no_grad()
def calibrate_batchtopk_threshold(params: Mapping[str, torch.Tensor], cfg: CrossCoderConfig,
                                  batches) -> float:
    """Mean per-batch BatchTopK threshold over representative batches: the
    fixed global threshold for eval (set it as ``cfg.batchtopk_threshold``;
    :func:`encode` then runs ``batchtopk_fixed``). ``batches``: iterable of
    ``[B, n_sources, d_in]`` batches, normalized as training batches were.
    Params and batches are cast to ``cfg.enc_dtype`` first, so the order
    statistic comes from the pre-acts training saw."""
    dt = dtype_of(cfg.enc_dtype)
    cp = cast_params(params, dt)
    dev = cp["W_enc"].device
    vals = [float(act_ops.batchtopk_threshold_of(
                torch.relu(pre_acts(cp, torch.as_tensor(b).to(dev).to(dt))), cfg.topk_k))
            for b in batches]
    if not vals:
        raise ValueError("calibrate_batchtopk_threshold needs >= 1 batch")
    return float(np.mean(vals))


def decode(params: Mapping[str, torch.Tensor], f: torch.Tensor, mesh=None) -> torch.Tensor:
    """Reconstruction ``[B, n, d_in]`` from latents ``[B, d_hidden]``
    (under a ``mesh``: this rank's latents and ``W_dec`` rows, the partial
    products summed over ``model`` before ``b_dec``)."""
    W = params["W_dec"]
    H, n, d = W.shape
    y = matmul_f32(f.reshape(-1, H), W.reshape(H, n * d))
    if mesh is not None:
        y = mesh.sum_model(y)
    return (y + params["b_dec"].float().reshape(1, n * d)).to(f.dtype).reshape(*f.shape[:-1], n, d)


def forward(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: CrossCoderConfig
            ) -> torch.Tensor:
    return decode(params, encode(params, x, cfg))


# ---------------------------------------------------------------------------
# TopK tiers


def _decode_rows(vals: torch.Tensor, idx: torch.Tensor, W_dec: torch.Tensor) -> torch.Tensor:
    """``Σ_j vals[b, j] · W_dec[idx[b, j]]`` → ``[B, n, d]`` f32, through
    the k active decoder rows only."""
    H, n, d = W_dec.shape
    w = W_dec.reshape(H, n * d)[idx.long()]                       # [B, k, n*d]
    return torch.bmm(vals.float()[:, None, :], w.float())[:, 0].reshape(-1, n, d)


def _d_vals(g_flat: torch.Tensor, idx: torch.Tensor, W_dec: torch.Tensor) -> torch.Tensor:
    """``<g[b], W_dec[idx[b, j]]>`` → ``[B, k]`` f32."""
    H, n, d = W_dec.shape
    w = W_dec.reshape(H, n * d)[idx.long()].float()               # [B, k, n*d]
    return torch.bmm(w, g_flat[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# the selection over a sharded dictionary axis (a mesh's ``model`` ranks)


def _order_key(values: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """One int64 key an entry: the f32 pattern of ``values`` mapped to a
    signed total order, then the inverted column, so the larger key is the
    larger value and, among equal values, the lower column."""
    bits = values.float().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (key << 32) | (0x7FFFFFFF - cols.to(torch.int64))


def _merge_keep(vals: torch.Tensor, idx: torch.Tensor, k: int, mesh, width: int
                ) -> torch.Tensor:
    """Which of this rank's row candidates ``(vals, idx)`` ``[B, kl]``
    (local columns of a ``width``-wide slice) are among the row's top
    ``k`` over every ``model`` rank: the candidates' keys (value, then
    lowest global column) gathered over ``model`` and cut at the k-th
    largest. ``torch.topk`` sees unique keys, so its order among ties
    never matters."""
    key = _order_key(vals, idx.to(torch.int64) + mesh.model_rank * width)
    every = mesh.gather_model(key)                                 # [m, B, kl]
    every = every.permute(1, 0, 2).reshape(key.shape[0], -1)
    kth = torch.topk(every, min(k, every.shape[-1]), dim=-1).values[:, -1:]
    return key >= kth


def _keep_global(vals: torch.Tensor, idx: torch.Tensor, k: int, mesh, width: int
                 ) -> torch.Tensor:
    """``vals`` with the candidates outside the global top ``k`` zeroed
    (their slots then act as the drain's ``(0, 0)`` padding); ``vals``
    itself without a mesh."""
    if mesh is None:
        return vals
    keep = _merge_keep(vals, idx, k, mesh, width)
    return torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def _kept_dense(f: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The mask ``f`` with only the entries ``(row, idx)`` whose ``vals``
    stay positive."""
    hits = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    hits.scatter_add_(1, idx.long(), (vals > 0).to(torch.int32))
    return torch.where(hits > 0, f, torch.zeros((), dtype=f.dtype, device=f.device))


def _local_topk(h: torch.Tensor, k: int, mesh) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mask, vals, idx)`` of the TopK of ``h``'s rows: the mask (K5, K6
    or K7) and its K8 drain, then, under a mesh, only the entries in the
    row's global top k (``h`` this rank's slice of the dictionary axis)."""
    width = h.shape[-1]
    kl = min(k, width)
    f = topk_pallas.topk_forward(h, kl)
    vals, idx = topk_pallas.sparsify(f, kl)
    if mesh is not None:
        vals = _keep_global(vals, idx, k, mesh, width)
        f = _kept_dense(f, idx, vals)
    return f, vals, idx


class _MeshTopK(torch.autograd.Function):
    """Dense TopK of a slice of the dictionary axis under a mesh: the
    local mask cut to the row's global top k; straight-through backward
    on the survivors (as :func:`topk_pallas.topk`)."""

    @staticmethod
    def forward(ctx, h, k, mesh):
        out, _, _ = _local_topk(h, k, mesh)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return topk_pallas._straight_through(out, g), None, None


def _bt_patterns_native(h: torch.Tensor) -> torch.Tensor:
    """K9's clamped patterns (``topk_pallas._bt_patterns``) in ``h``'s own
    width: int16 for bf16, int32 for f32 (sign set → 0, a negative NaN →
    the pattern below the top, the rest capped below the top)."""
    if h.dtype == torch.bfloat16:
        s, nan_neg, top = h.reshape(-1).view(torch.int16), -0x80, 0x7FFF
    else:
        s, nan_neg, top = h.reshape(-1).view(torch.int32), -0x800000, 0x7FFFFFFF
    below = torch.full((), top - 1, dtype=s.dtype, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    return torch.where(s < 0, torch.where(s > nan_neg, below, zero), torch.minimum(s, below))


def _global_kth(select, count, dtype: torch.dtype, kk: int, mesh, device) -> torch.Tensor:
    """The pattern of the ``kk``-th largest ReLU'd entry over every rank's
    pre-activations (int32 ``[1]`` on ``device``). ``select(kk)``: this
    rank's k-th pattern at the global budget (a device int32 ``[1]``), a
    lower bound (a rank with ``kk`` entries at or above its own k-th has
    them globally); the largest of those starts K9's multi-threshold
    bisection, where ``count(lo, hi)`` gives this rank's entries at or
    above each candidate of :func:`topk_pallas.bisection_mids`, summed over
    the ranks each pass. One pass ends it when no rank holds the bound's
    successor's share (always, on one rank)."""
    lo = int(mesh.max_world(select(kk))[0])
    hi = 0x7FFF if dtype == torch.bfloat16 else 0x7FFFFFFF
    while hi - lo > 1:
        counts = coll.all_reduce_(count(lo, hi), mesh.world_group)
        lo, hi = topk_pallas.narrow(lo, hi, topk_pallas.bisection_mids(lo, hi), counts.tolist(),
                                    kk)
    return torch.tensor([lo], dtype=torch.int32).to(device)


def _global_kth_pattern(h: torch.Tensor, kk: int, mesh) -> torch.Tensor:
    """:func:`_global_kth` over this rank's dense pre-activations ``h``:
    K9's select, and counts on its clamped patterns."""
    pats = _bt_patterns_native(h)

    def count(lo, hi):
        return torch.stack([(pats >= m).sum() for m in topk_pallas.bisection_mids(lo, hi)])

    return _global_kth(lambda kk: topk_pallas.batchtopk_select(h, kk), count, h.dtype, kk,
                       mesh, h.device)


def _bt_budget(rows: int, width: int, k: int, mesh) -> int:
    """BatchTopK's global budget from this rank's ``rows`` and dictionary
    ``width`` on a grid: ``min(k·B, B·H)`` of the global batch and
    dictionary."""
    rows *= mesh.data_size
    return min(k * rows, rows * width * mesh.model_size)


class _MeshBatchTopK(torch.autograd.Function):
    """BatchTopK over the global batch and the whole dictionary axis under
    a mesh: the threshold of :func:`_global_kth_pattern`, then K9's emit on
    this rank's ``h``; straight-through backward on the survivors."""

    @staticmethod
    def forward(ctx, h, k, mesh):
        kk = _bt_budget(h.shape[0], h.shape[-1], k, mesh)
        out = topk_pallas.batchtopk_emit(h, _global_kth_pattern(h, kk, mesh))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return topk_pallas._straight_through(out, g), None, None


def _activate(h: torch.Tensor, cfg: CrossCoderConfig, params: Mapping[str, torch.Tensor],
              mesh) -> torch.Tensor:
    """The activation of :func:`act_ops.apply`; under a mesh, TopK and
    training BatchTopK select over every rank (ReLU, JumpReLU and the fixed
    BatchTopK threshold are elementwise and stay local)."""
    if mesh is not None and cfg.activation == "topk":
        return _MeshTopK.apply(h, cfg.topk_k, mesh)
    if mesh is not None and cfg.activation == "batchtopk" and cfg.batchtopk_threshold <= 0:
        return _MeshBatchTopK.apply(h, cfg.topk_k, mesh)
    return act_ops.apply(h, cfg, dict(params))


class _FactoredTopK(torch.autograd.Function):
    """``(recon [B,n,d] f32 (no b_dec), vals, idx)`` from pre-acts ``h``:
    the mask (K5, K6 or K7) → K8 drain → k-row decode; backward through the dense
    matmuls, exactly as the dense TopK path. ``vals``/``idx`` carry no
    gradient (sound only with l1_coeff == 0, which the gate ensures)."""

    @staticmethod
    def forward(ctx, h, W_dec, k, mesh=None):
        f, vals, idx = _local_topk(h, k, mesh)
        ctx.save_for_backward(f, W_dec)
        ctx.mark_non_differentiable(vals, idx)
        return _decode_rows(vals, idx, W_dec), vals, idx

    @staticmethod
    def backward(ctx, g, _gv, _gi):
        f, W_dec = ctx.saved_tensors
        H, n, d = W_dec.shape
        g_flat = g.float().reshape(-1, n * d)
        ff = f.float()
        dW_dec = torch.mm(ff.t(), g_flat).reshape(H, n, d).to(W_dec.dtype)
        df = torch.mm(g_flat, W_dec.reshape(H, n * d).float().t())
        dh = torch.where(f > 0, df, torch.zeros((), device=df.device)).to(f.dtype)
        return dh, dW_dec, None, None


def _sparse_step_backward(ctx, g):
    """The sparse plane's backward, shared by the sparse and fused steps:
    d_vals through the k active decoder rows, straight-through on the
    survivors; dW_dec and (dW_enc, db_enc) as K10 scatters."""
    x, vals, idx, W_enc, W_dec = ctx.saved_tensors
    B = vals.shape[0]
    H, n, d = W_dec.shape
    nd = n * d
    g_flat = g.float().reshape(B, nd)
    # this rank's sources' share, summed over the source group (shard_sources)
    d_vals = coll.all_reduce_(_d_vals(g_flat, idx, W_dec), ctx.src_group)
    d_vals = torch.where(vals > 0, d_vals, torch.zeros((), device=d_vals.device))
    dW_dec = sparse_grad.scatter_add_rows(vals.float(), idx, g_flat, H)
    dW_dec = dW_dec.reshape(H, n, d).to(W_dec.dtype)
    # one scatter over the batch rows with a ones column (lane block of
    # 128, as the JAX package pads it) so db_enc rides the same sums
    ones = torch.zeros((B, 128), dtype=torch.float32, device=x.device)
    ones[:, 0] = 1.0
    x_aug = torch.cat([x.reshape(B, nd).float(), ones], dim=1)
    enc = sparse_grad.scatter_add_rows(d_vals, idx, x_aug, H)
    dW_enc = enc[:, :nd].reshape(H, n, d).permute(1, 2, 0).to(W_enc.dtype).contiguous()
    db_enc = enc[:, nd].to(ctx.b_dtype)
    dx = None
    if ctx.needs_input_grad[0]:
        we = W_enc.reshape(nd, H).t()[idx.long()].float()          # [B, k, nd]
        dx = torch.bmm(d_vals[:, None, :], we)[:, 0].reshape(B, n, d).to(x.dtype)
    return dx, dW_enc, db_enc, dW_dec


def _whole_contraction(x: torch.Tensor, W_enc: torch.Tensor, src_group, x_all
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused kernels' operands ``(x2 [B, n·d], W2 [n·d, H])``: this
    rank's own under a dictionary split; under ``shard_sources``
    (``src_group``) the whole contraction, since a fused kernel selects
    after the product and cannot sum partial products first: the batch's
    every source (``x_all``) and every rank's source slab of ``W_enc``,
    gathered over the source group (GSPMD's all-gather around the JAX
    kernel; ``(m - 1)/m`` of ``W_enc`` crosses to each rank)."""
    if src_group is not None:
        x, W_enc = x_all, coll.all_gather_cat(W_enc, 0, src_group)
    n, d, H = W_enc.shape
    return x.reshape(x.shape[0], n * d), W_enc.reshape(n * d, H)


class _SparseTopKStep(torch.autograd.Function):
    """``(recon [B,n,d] f32 (no b_dec), vals, idx)`` from the batch: encode
    + the mask + K8 + k-row decode in one scope (``fused``: the K2
    encoder→TopK kernel in place of encode + mask + K8, K3 with
    ``quant_block > 0``), so the backward never leaves factored form.
    Under a ``mesh`` the candidates of this rank's dictionary slice are cut
    to the row's global top k (:func:`_keep_global`, the global column
    offset in its key). ``src_group``: the source group under
    ``shard_sources`` (``x``, ``W_enc`` and ``W_dec`` this rank's sources;
    the encode's partial products and the backward's ``d_vals`` sum over
    it; ``fused`` runs on the whole contraction, ``x_all`` the batch's
    every source, :func:`_whole_contraction`). Soundness gate: l1_coeff == 0."""

    @staticmethod
    def forward(ctx, x, W_enc, b_enc, W_dec, k, fused, quant_block, mesh=None, src_group=None,
                x_all=None):
        H = W_enc.shape[2]
        # the dense encode sums this rank's partial products over the sources
        x2, W2 = _whole_contraction(x, W_enc, src_group if fused else None, x_all)
        if fused:
            vals, idx = fek.fused_topk_encode(x2, W2, b_enc, k, quant_block=quant_block)
            vals = _keep_global(vals, idx, k, mesh, H)
        else:
            h = (coll.all_reduce_(_mm32(x2, W2), src_group) + b_enc.float()).to(x.dtype)
            _, vals, idx = _local_topk(h, k, mesh)
        ctx.save_for_backward(x, vals, idx, W_enc, W_dec)
        ctx.src_group = src_group
        ctx.b_dtype = b_enc.dtype
        ctx.mark_non_differentiable(vals, idx)
        return _decode_rows(vals, idx, W_dec), vals, idx

    @staticmethod
    def backward(ctx, g, _gv, _gi):
        return (*_sparse_step_backward(ctx, g), None, None, None, None, None, None)


class _FusedBatchTopKEncode(torch.autograd.Function):
    """BatchTopK activations ``f [B, H]`` in x's dtype with the encoder
    product and the global selection fused (K4,
    :func:`fek.fused_batchtopk_encode`), equal to ``batchtopk(pre_acts(x),
    k)``. Under a ``mesh`` the threshold is global over the batch and the
    dictionary (:func:`_global_kth` from K4's select and count entries),
    then K4's emit on this rank's slice; ``src_group``/``x_all`` as
    :class:`_SparseTopKStep`'s (the whole contraction under
    ``shard_sources``). The backward is the dense path's: straight-through
    on the survivors (``dh = g·[f > 0]`` in f32, ``db_enc = Σ dh``), then
    the encoder matmuls' on this rank's ``x`` and ``W_enc`` (the JAX
    ``_fused_batchtopk_encode_bwd``)."""

    @staticmethod
    def forward(ctx, x, W_enc, b_enc, k, mesh=None, src_group=None, x_all=None):
        x2, W2 = _whole_contraction(x, W_enc, src_group, x_all)
        if mesh is None:
            f = fek.fused_batchtopk_encode(x2, W2, b_enc, k)
        else:
            kth = _global_kth(lambda kk: fek.fused_batchtopk_select(x2, W2, b_enc, kk),
                              lambda lo, hi: fek.fused_batchtopk_count(x2, W2, b_enc, lo, hi),
                              x2.dtype, _bt_budget(x2.shape[0], W2.shape[1], k, mesh), mesh,
                              x2.device)
            f = fek.fused_batchtopk_emit(x2, W2, b_enc, kth)
        ctx.save_for_backward(x, W_enc, f)
        ctx.b_dtype = b_enc.dtype
        return f

    @staticmethod
    def backward(ctx, g):
        x, W_enc, f = ctx.saved_tensors
        B = x.shape[0]
        n, d, H = W_enc.shape
        x2 = x.reshape(B, n * d)
        W2 = W_enc.reshape(n * d, H)
        dh = torch.where(f > 0, g, torch.zeros((), dtype=g.dtype, device=g.device)).float()
        db_enc = dh.sum(dim=0).to(ctx.b_dtype)
        dW_enc = _mm32(x2.t(), _cot(dh, x2)).reshape(n, d, H).to(W_enc.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _mm32(_cot(dh, W2), W2.t()).reshape(B, n, d).to(x.dtype)
        return dx, dW_enc, db_enc, None, None, None, None


class _SparseTopKFromH(torch.autograd.Function):
    """The (h, W_dec)-scoped sparse variant for AuxK steps: the factored
    forward, backward with dW_dec through K10 and ``dh`` scattered back
    to ``[B, H]`` (h has other consumers: the aux ranking)."""

    @staticmethod
    def forward(ctx, h, W_dec, k, mesh=None):
        _, vals, idx = _local_topk(h, k, mesh)
        ctx.save_for_backward(vals, idx, W_dec)
        ctx.h_dtype = h.dtype
        ctx.mark_non_differentiable(vals, idx)
        return _decode_rows(vals, idx, W_dec), vals, idx

    @staticmethod
    def backward(ctx, g, _gv, _gi):
        vals, idx, W_dec = ctx.saved_tensors
        B = vals.shape[0]
        H, n, d = W_dec.shape
        g_flat = g.float().reshape(B, n * d)
        d_vals = _d_vals(g_flat, idx, W_dec)
        d_vals = torch.where(vals > 0, d_vals, torch.zeros((), device=d_vals.device))
        dW_dec = sparse_grad.scatter_add_rows(vals.float(), idx, g_flat, H)
        rows = torch.arange(B, device=idx.device)[:, None].expand_as(idx)
        dh = torch.zeros((B, H), dtype=ctx.h_dtype, device=idx.device)
        dh.index_put_((rows, idx.long()), d_vals.to(ctx.h_dtype), accumulate=True)
        return dh, dW_dec.reshape(H, n, d).to(W_dec.dtype), None, None


class _SparseAuxProduct(torch.autograd.Function):
    """AuxK decode ``e_hat [B,n,d] f32``: the dense forward (aux
    activations scattered to ``[B, H]``, one matmul), the backward through
    the aux_k gathered rows (d_avals) and K10 (dW_dec)."""

    @staticmethod
    def forward(ctx, avals, aidx, W_dec):
        B = avals.shape[0]
        H, n, d = W_dec.shape
        rows = torch.arange(B, device=aidx.device)[:, None].expand_as(aidx)
        f_aux = torch.zeros((B, H), dtype=avals.dtype, device=avals.device)
        f_aux.index_put_((rows, aidx.long()), avals, accumulate=True)
        ctx.save_for_backward(avals, aidx, W_dec)
        return _mm32(f_aux, W_dec.reshape(H, n * d)).reshape(B, n, d)

    @staticmethod
    def backward(ctx, g):
        avals, aidx, W_dec = ctx.saved_tensors
        B = avals.shape[0]
        H, n, d = W_dec.shape
        g_flat = g.float().reshape(B, n * d)
        d_avals = _d_vals(g_flat, aidx, W_dec).to(avals.dtype)
        dW_dec = sparse_grad.scatter_add_rows(avals.float(), aidx, g_flat, H)
        return d_avals, None, dW_dec.reshape(H, n, d).to(W_dec.dtype)


class _SparseDecodeProduct(torch.autograd.Function):
    """``Σ_j vals[b, j] · W_dec[idx[b, j]]`` → ``[B, n, d]`` f32 through
    the k active rows; backward: ``d_vals`` through the same rows, ``dW_dec``
    by scattering ``vals`` into a dense ``[B, H]`` matrix and one product
    (the JAX package's dense-scatter trick; on the card from bf16 operands
    on the tensor cores, as the dense path's backward)."""

    @staticmethod
    def forward(ctx, vals, idx, W_dec):
        ctx.save_for_backward(vals, idx, W_dec)
        return _decode_rows(vals, idx, W_dec)

    @staticmethod
    def backward(ctx, g):
        vals, idx, W_dec = ctx.saved_tensors
        B = vals.shape[0]
        H, n, d = W_dec.shape
        g_flat = g.float().reshape(B, n * d)
        d_vals = _d_vals(g_flat, idx, W_dec).to(vals.dtype)
        rows = torch.arange(B, device=idx.device)[:, None].expand_as(idx)
        f_dense = torch.zeros((B, H), dtype=vals.dtype, device=vals.device)
        f_dense.index_put_((rows, idx.long()), vals.detach(), accumulate=True)
        dW_dec = _mm32(f_dense.t(), _cot(g_flat, f_dense)).reshape(H, n, d).to(W_dec.dtype)
        return d_vals, None, dW_dec


def topk_vals_idx(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: CrossCoderConfig,
                  mesh=None, src_group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """TopK encode in factored form: ``(vals [B, k], idx [B, k] int32)``.
    The selected set comes from the mask (K5, K6 or K7) and the K8 drain
    (their plain versions on CPU tensors): the entries > 0 of each row's k
    largest ReLU'd pre-activations, ties to the lowest index, in ascending
    index order. ``vals`` are gathered from ``relu(h)``, so gradients reach
    ``W_enc``/``b_enc`` through the gather; a row with fewer than k
    positives pads its slots with value 0 (the drain's ``(0, 0)``, whose
    gathered column 0 is masked out). ``mesh``: this rank's dictionary
    slice, its candidates cut to the row's global top k; ``src_group``:
    the sources' group under ``shard_sources`` (:func:`pre_acts`)."""
    h = pre_acts(params, x, src_group)
    hp = act_ops.relu(h)
    with torch.no_grad():
        _, sel, idx = _local_topk(h.detach(), cfg.topk_k, mesh)
    vals = hp.gather(-1, idx.long())
    vals = torch.where(sel > 0, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return vals, idx


def sparse_topk_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                        cfg: CrossCoderConfig, mesh=None, src_group=None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TopK encode + the k-row decode: ``(recon [B, n, d] f32, vals,
    idx)``, the dense path's reconstruction up to f32 summation order.
    Under a ``mesh`` each rank decodes its surviving candidates against its
    own ``W_dec`` rows and the partial reconstructions sum over ``model``
    (``d_vals`` and ``dW_dec`` stay local); under ``shard_sources``
    (``src_group``) the replicated latents decode this rank's sources,
    their gradient summed over the source group."""
    vals, idx = topk_vals_idx(params, x, cfg, mesh, src_group)
    recon = _SparseDecodeProduct.apply(coll.copy_to(vals, src_group), idx, params["W_dec"])
    if mesh is not None:
        recon = mesh.sum_model(recon)
    return recon + params["b_dec"].float(), vals, idx


# ---------------------------------------------------------------------------
# tier gates (the JAX package's, with "kernel live" read as true but for
# the opt-in fused encoder)

_FUSED_DEMOTION_WARNED: set[str] = set()


def use_factored_decode(cfg: CrossCoderConfig) -> bool:
    """The factored TopK tier: "off" never; "on" whenever sound
    (l1_coeff == 0) and the JAX package's TopK/sparsify gates take the
    dictionary; "auto" also needs dict_size >= 2^17 or sparse_bwd "on"."""
    if cfg.activation != "topk" or cfg.sparse_decode:
        return False
    if cfg.factored_decode == "off" or cfg.l1_coeff != 0:
        return False
    if not topk_pallas.supported(cfg.dict_size, cfg.topk_k, dtype_of(cfg.enc_dtype)):
        return False
    if not topk_pallas.sparsify_supported(cfg.dict_size, cfg.topk_k):
        return False
    return cfg.factored_decode == "on" or cfg.dict_size >= 131072 or cfg.sparse_bwd == "on"


def use_sparse_bwd(cfg: CrossCoderConfig, batch: int | None = None) -> bool:
    """The sparse backward plane (``cfg.sparse_bwd``), on top of the
    factored tier: "on" whenever sound; "auto" also needs the JAX
    package's scatter gate to take both scatter shapes of the step."""
    if cfg.activation != "topk" or cfg.sparse_decode:
        return False
    if cfg.sparse_bwd == "off" or cfg.l1_coeff != 0:
        return False
    if cfg.sparse_bwd == "on":
        return True
    return batch is None or sparse_grad.decode_grad_supported(
        cfg.dict_size, cfg.topk_k, cfg.n_sources, cfg.d_in, batch)


def use_sparse_aux(cfg: CrossCoderConfig, batch: int) -> bool:
    """The sparse backward for the AuxK term: the sparse plane active and
    the JAX package's scatter gate taking ``batch · aux_k`` pairs ("auto"
    also needs ``aux_k · 512 <= dict_size``)."""
    if cfg.aux_k <= 0 or not use_sparse_bwd(cfg):
        return False
    k_aux = min(cfg.aux_k, cfg.dict_size)
    aux_ok = sparse_grad.supported(cfg.dict_size, cfg.n_sources * cfg.d_in, batch,
                                   batch * k_aux)
    if cfg.sparse_bwd == "on":
        return aux_ok
    return aux_ok and cfg.aux_k * 512 <= cfg.dict_size


def _warn_fused_demoted(reason: str) -> None:
    if reason not in _FUSED_DEMOTION_WARNED:
        _FUSED_DEMOTION_WARNED.add(reason)
        print(f"[crosscoder_tpu_torch] fused_encoder='on' demoted to the "
              f"dense encode: {reason}", file=sys.stderr, flush=True)


def use_fused_encoder(cfg: CrossCoderConfig, batch: int | None = None) -> bool:
    """The fused encoder tier (``cfg.fused_encoder``): "off" never, "auto"
    the dense encode, "on" the fused kernel where it applies. The JAX
    package's "auto" takes its fused kernels only where
    ``CROSSCODER_FUSED_TOPK_PALLAS=1`` opts in, so "on" is the port's
    opt-in. For ``topk`` "on" takes K2 (K3 under ``quant_encoder``) when
    the factored tier and the sparse plane are live; for ``batchtopk`` it
    takes K4 in training mode. An "on" demoted by a dead prerequisite tier,
    or by a calibrated BatchTopK threshold (eval mode, no selection to
    fuse), warns once on stderr. AuxK steps keep the dense encode at the
    call site (the aux ranking needs the pre-activations)."""
    if cfg.fused_encoder != "on":
        return False
    if cfg.activation == "batchtopk":
        if cfg.batchtopk_threshold > 0:
            _warn_fused_demoted("batchtopk_threshold > 0 is eval mode — a calibrated "
                                "fixed threshold has no bisection to fuse")
            return False
        return True
    if cfg.activation != "topk":
        return False
    if not (use_factored_decode(cfg) and use_sparse_bwd(cfg, batch)):
        _warn_fused_demoted("activation='topk' needs the factored tier and the sparse "
                            "backward plane live (use_factored_decode/use_sparse_bwd "
                            "resolved off)")
        return False
    return True


# ---------------------------------------------------------------------------
# losses


def get_losses(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: CrossCoderConfig,
               with_metrics: bool = True, dead_mask: torch.Tensor | None = None,
               track_fired: bool = False, mesh=None) -> LossOutput:
    """The loss surface of a batch ``x [B, n_sources, d_in]`` (reference
    ``crosscoder.py:96-130``, f32 reductions). ``with_metrics=False``
    returns zeros for the metric-only terms (l0, explained variances, and
    l1 when ``cfg.l1_coeff == 0``).

    Under a ``mesh`` (:class:`crosscoder_tpu_torch.parallel.mesh.Mesh`)
    ``x`` is this rank's rows, the params its shards (the dictionary axis
    split over ``model``), and the collectives the JAX package's GSPMD
    inserts are written out: TopK and AuxK select over every ``model``
    rank's candidates, BatchTopK's threshold counts over every rank, the
    decodes' partial sums add over ``model``; ``l2``, ``l1`` and the AuxK
    ratio's numerator and denominator are global means (differentiable,
    replicated on every rank), ``fired`` is an OR over ``data``, the
    explained variance centres by the global batch mean. ``l0_loss`` and
    the explained variances stay this rank's partials (the step reduces
    them with its other metrics).

    Under a ``shard_sources`` mesh ``model`` splits the sources (the JAX
    ``_SOURCE_SPECS``): this rank encodes its slab of ``x`` (all sources
    passed) and the pre-activations sum over ``model``; the activation
    runs on the whole replicated dictionary (the statistics over ``data``
    only, :meth:`Mesh.dict_view`); the decode writes this rank's sources,
    and every sum over sources (L2, the L1 weight ``Σ_s ‖W_dec[:, s]‖``,
    the AuxK ratio, the variances) sums over ``model``. A replicated
    latent entering a decode of this rank's sources passes
    :func:`~crosscoder_tpu_torch.parallel.collectives.copy_to`, so its
    gradient sums the sources' shares."""
    n_sources = x.shape[-2]
    src_group = x_all = None
    if mesh is not None and cfg.shard_sources:
        src_group = mesh.model_group
        x_all = x.to(dtype_of(cfg.enc_dtype))         # the fused kernels' whole contraction
        x = x[..., mesh.source_slice(n_sources), :]
        mesh = mesh.dict_view()
    x = x.to(dtype_of(cfg.enc_dtype))
    B = x.shape[0]
    factored = use_factored_decode(cfg)
    sparse = factored or (cfg.sparse_decode and cfg.activation == "topk")
    l0_penalty: torch.Tensor | float = 0.0
    h = None
    aux_active = dead_mask is not None and cfg.aux_k > 0
    sparse_bwd = factored and use_sparse_bwd(cfg, B)
    fused = use_fused_encoder(cfg, B)
    b_dec = params["b_dec"].float()
    sum_model = mesh.sum_model if mesh is not None else (lambda t: t)

    def to_sources(t):      # a replicated latent into this rank's sources' decode
        return coll.copy_to(t, src_group)

    if factored and sparse_bwd and not aux_active:
        qb = cfg.quant_block if fused and cfg.quant_encoder else 0
        recon_f32, vals, idx = _SparseTopKStep.apply(
            x, params["W_enc"], params["b_enc"], params["W_dec"], cfg.topk_k, fused, qb, mesh,
            src_group, x_all)
        recon = (sum_model(recon_f32) + b_dec).to(x.dtype)
        f = None
    elif factored:
        h = pre_acts(params, x, src_group)
        tier = _SparseTopKFromH if sparse_bwd else _FactoredTopK
        recon_f32, vals, idx = tier.apply(to_sources(h), params["W_dec"], cfg.topk_k, mesh)
        recon = (sum_model(recon_f32) + b_dec).to(x.dtype)
        f = None
    elif sparse:
        recon_f32, vals, idx = sparse_topk_forward(params, x, cfg, mesh, src_group)
        recon = recon_f32.to(x.dtype)
        f = None
    elif cfg.activation == "batchtopk" and fused and not aux_active:
        f = _FusedBatchTopKEncode.apply(x, params["W_enc"], params["b_enc"], cfg.topk_k, mesh,
                                        src_group, x_all)
        recon = decode(params, to_sources(f), mesh)
    elif cfg.activation == "jumprelu" and cfg.l0_coeff > 0:
        h = pre_acts(params, x, src_group)
        f = _activate(h, cfg, params, mesh)
        recon = decode(params, to_sources(f), mesh)
        l0_penalty = act_ops.jumprelu_l0(h, params["log_theta"], cfg.jumprelu_bandwidth)
        if mesh is not None:
            l0_penalty = mesh.sum_world(l0_penalty) / mesh.data_size
    else:
        h = pre_acts(params, x, src_group)
        f = _activate(h, cfg, params, mesh)
        recon = decode(params, to_sources(f), mesh)

    xf = x.float()
    rf = recon.float()
    err2 = torch.square(rf - xf)
    l2_per_row = coll.sum_over(err2.sum(dim=(-2, -1)), src_group)
    l2_loss = l2_per_row.mean()
    if mesh is not None:
        l2_loss = mesh.mean_data(l2_loss)

    need_l1 = with_metrics or cfg.l1_coeff != 0
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if not need_l1:
        l1_loss = zero
    else:
        total_dec_norm = coll.sum_over(
            torch.linalg.norm(params["W_dec"].float(), dim=-1).sum(dim=-1), src_group)
        if sparse:
            w_active = total_dec_norm[idx.long()]
            l1_loss = (vals.float() * w_active).sum(dim=-1).mean()
        else:
            l1_loss = (f.float() * total_dec_norm[None, :]).sum(dim=-1).mean()
        if mesh is not None:
            l1_loss = mesh.sum_world(l1_loss) / mesh.data_size

    aux_loss: torch.Tensor | float = 0.0
    fired = None
    d_hidden = params["W_dec"].shape[0]
    if track_fired or aux_active:
        if sparse:
            hits = torch.zeros((d_hidden,), dtype=torch.int32, device=x.device)
            hits.index_add_(0, idx.reshape(-1).long(), (vals.reshape(-1) > 0).to(torch.int32))
            fired = hits > 0
        else:
            fired = (f > 0).any(dim=0)
        if mesh is not None:
            fired = mesh.any_(fired, "data")
    if aux_active:
        k_aux = min(cfg.aux_k, d_hidden * (mesh.model_size if mesh is not None else 1))
        h_all = h if h is not None else pre_acts(params, x, src_group)
        neg = torch.finfo(h_all.dtype).min
        ranked = torch.where(dead_mask[None, :], h_all.detach(),
                             torch.full((), neg, dtype=h_all.dtype, device=x.device))
        aidx = _exact_topk_indices(ranked, min(k_aux, d_hidden))
        avals = torch.gather(h_all, 1, aidx)
        keep = dead_mask[aidx]
        if mesh is not None:
            keep = keep & _merge_keep(ranked.gather(1, aidx), aidx, k_aux, mesh, d_hidden)
        avals = torch.where(keep, avals, torch.zeros((), dtype=avals.dtype, device=x.device))
        avals = to_sources(avals)
        e = (xf - rf).detach()
        if use_sparse_aux(cfg, B):
            e_hat = _SparseAuxProduct.apply(avals.to(x.dtype), aidx, params["W_dec"])
        else:
            rows = torch.arange(B, device=x.device)[:, None].expand_as(aidx)
            f_aux = torch.zeros((B, d_hidden), dtype=x.dtype, device=x.device)
            f_aux = f_aux.index_put((rows, aidx), avals.to(x.dtype), accumulate=True)
            W = params["W_dec"]
            e_hat = matmul_f32(f_aux, W.reshape(d_hidden, -1)).reshape(B, *W.shape[1:])
        e_hat = sum_model(e_hat)
        num = coll.sum_over(torch.square(e_hat - e).sum(dim=(-2, -1)), src_group).mean()
        den = coll.sum_over(torch.square(e).sum(dim=(-2, -1)), src_group).mean()
        any_dead = dead_mask.any()
        if mesh is not None:
            num, den = mesh.mean_data(torch.stack([num, den])).unbind(0)
            any_dead = mesh.any_(any_dead, "model")
        aux_loss = torch.where(any_dead, num / (den + 1e-8), zero)

    if not with_metrics:
        return LossOutput(l2_loss, l1_loss, zero, torch.zeros_like(l2_per_row),
                          torch.zeros((n_sources, B), dtype=torch.float32, device=x.device),
                          l0_penalty, aux_loss, fired)

    eps = 1e-8
    mean = xf.mean(dim=0, keepdim=True)
    if mesh is not None:
        mean = mesh.mean_data(mean)
    centered = xf - mean
    tot_var = coll.sum_over(torch.square(centered).sum(dim=(-2, -1)), src_group)
    explained_variance = 1.0 - l2_per_row / (tot_var + eps)
    l2_per_source = err2.sum(dim=-1)
    var_per_source = torch.square(centered).sum(dim=-1)
    ev_per_source = 1.0 - l2_per_source / (var_per_source + eps)
    if src_group is not None:       # every rank's sources, in source order
        ev_per_source = coll.all_gather_cat(ev_per_source.detach(), 1, src_group)
    if sparse:
        l0_loss = (vals > 0).float().sum(dim=-1).mean()
    else:
        l0_loss = (f > 0).float().sum(dim=-1).mean()
    return LossOutput(l2_loss, l1_loss, l0_loss, explained_variance, ev_per_source.t(),
                      l0_penalty, aux_loss, fired)


def _exact_topk_indices(ranked: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries per row, ties to the lowest index
    (``lax.top_k``'s order), through one int64 key per entry: the f32
    pattern mapped to a signed total order, then the inverted column, so
    ``torch.topk``'s unspecified order among equal values never matters."""
    col = torch.arange(ranked.shape[-1], device=ranked.device)
    return torch.topk(_order_key(ranked, col), k, dim=-1).indices


def cast_params(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Params:
    """Weight leaves in the compute dtype (``log_theta`` stays f32)."""
    return {k: (v if k == "log_theta" else v.to(dtype)) for k, v in params.items()}


def training_loss(params: Mapping[str, torch.Tensor], x: torch.Tensor, l1_coeff,
                  cfg: CrossCoderConfig, with_metrics: bool = True,
                  dead_mask: torch.Tensor | None = None, aux_coeff=None,
                  track_fired: bool = False, l0_coeff=None,
                  mesh=None) -> tuple[torch.Tensor, LossOutput]:
    """Scalar objective ``l2 + l1_coeff · l1`` (+ ``l0_coeff ·
    l0_penalty`` for JumpReLU with ``cfg.l0_coeff > 0``, ``l0_coeff``
    defaulting to it; + ``aux_coeff · aux_loss`` on AuxK steps) and the
    loss surface. Params may be f32 masters; they are cast to
    ``cfg.enc_dtype`` here (differentiably; ``log_theta`` stays f32).
    ``mesh``: the loss over a rank grid (:func:`get_losses`)."""
    if not with_metrics and cfg.l1_coeff == 0 and float(l1_coeff) != 0.0:
        raise ValueError(
            f"training_loss got l1_coeff={float(l1_coeff)} but cfg.l1_coeff == 0 and "
            f"with_metrics=False: the L1 term is skipped on this path, so the "
            f"sparsity penalty would be silently dropped")
    losses = get_losses(cast_params(params, dtype_of(cfg.enc_dtype)), x, cfg, with_metrics,
                        dead_mask=dead_mask, track_fired=track_fired, mesh=mesh)
    loss = losses.l2_loss + l1_coeff * losses.l1_loss
    if cfg.l0_coeff > 0:
        eff = cfg.l0_coeff if l0_coeff is None else l0_coeff
        loss = loss + eff * losses.l0_penalty
    if cfg.aux_k > 0 and dead_mask is not None:
        eff_aux = cfg.aux_k_coeff if aux_coeff is None else aux_coeff
        loss = loss + eff_aux * losses.aux_loss
    return loss, losses


def param_count(cfg: CrossCoderConfig) -> int:
    n, d, h = cfg.n_sources, cfg.d_in, cfg.dict_size
    count = 2 * n * d * h + h + n * d
    if cfg.activation == "jumprelu":
        count += h  # log_theta
    return count


def fold_scaling_factors(params: Mapping[str, torch.Tensor], factors: Any) -> Params:
    """Fold per-source activation-normalization factors ``s`` into the
    weights (reference ``nb:cell 27``): ``W_enc[n] *= s[n]``,
    ``W_dec[:, n] /= s[n]``, ``b_dec[n] /= s[n]``."""
    s = torch.as_tensor(factors, dtype=torch.float32, device=params["W_enc"].device)
    out = dict(params)
    out["W_enc"] = (params["W_enc"].float() * s[:, None, None]).to(params["W_enc"].dtype)
    out["W_dec"] = (params["W_dec"].float() / s[None, :, None]).to(params["W_dec"].dtype)
    out["b_dec"] = (params["b_dec"].float() / s[:, None]).to(params["b_dec"].dtype)
    return out


class CrossCoder(nn.Module):
    """The crosscoder's params as a trainable ``nn.Module``. ``forward``
    encodes and decodes under ``cfg``, or gives the pre-activations when
    no ``cfg`` is set."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: CrossCoderConfig | None = None
                 ) -> None:
        super().__init__()
        self.cfg = cfg
        for name in ("W_enc", "W_dec", "b_enc", "b_dec", "log_theta"):
            if name in params:
                self.register_parameter(name, nn.Parameter(params[name]))

    def params(self) -> Params:
        return {name: p for name, p in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg is None:
            return pre_acts(self.params(), x)
        return forward(self.params(), x, self.cfg)

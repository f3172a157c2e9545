"""Gemma-2 runtime with capture and edits, ported from
:mod:`crosscoder_tpu.models.lm`.

The architecture config, random init, weight loading from an HF-layout
state dict or a local HF checkpoint (:func:`from_torch_state_dict`,
:func:`from_hf`), the padded forward with logits and edits
(:func:`forward`, :func:`loss_fn`, :func:`ce_loss`: the CE-recovered
eval and the demo's training), the padded capture forward
(:func:`run_with_cache_multi`: the test oracle and the norm calibration;
:class:`SegmentedHarvest`, the same forward in quanta of a few blocks: the
replay buffer's refill) and the paged capture forward
(:func:`paged_capture`, the serve prefill; :func:`run_with_cache_multi_paged`,
the paged harvest). All share one block loop (:func:`_run_layers`).
Params are a plain dict with the JAX package's leaf names and layout:
layer leaves stacked on a leading ``[n_layers]`` axis, matmul weights
``[in, out]``, so :mod:`crosscoder_tpu_torch.convert` carries them across
unchanged.

Gemma-2 facts implemented: RMSNorm with (1+w) scale in fp32; embedding
scaled by sqrt(d_model) in the model dtype; GeGLU MLP with tanh GELU; GQA;
split-half RoPE; attention-logit softcap; alternating sliding-window
(even layers) and global attention; query scale
``query_pre_attn_scalar**-0.5``. Matmuls run in the model dtype with fp32
accumulation (``torch.matmul``); in bf16 their outputs round to bf16
before the GELU, where the JAX package keeps fp32, which is one bf16
rounding apart. The logits are f32: the tied unembedding sums in f32 and
returns f32, as the JAX package's ``preferred_element_type`` does.

A capture forward runs only the blocks below the highest hooked layer:
``blocks.14.hook_resid_pre`` runs 14 of Gemma-2-2B's 26 blocks.

Two parallel forms, over the rank grid of
:mod:`crosscoder_tpu_torch.parallel.mesh`:

- **Tensor-parallel** (:func:`tp_shardings`, :func:`shard_params_tp`,
  ``from_hf(..., tp=mesh)``): each ``model`` rank keeps the Megatron
  slices of every matmul leaf (heads of ``wq``/``wk``/``wv``, the
  contracting axis of ``wo``/``w_down``, the hidden axis of
  ``w_gate``/``w_up``, the ``d_model`` axis of ``embed``; norms whole).
  The params carry their group under the marker key ``"tp"`` (a
  :class:`TPGroup`), and every forward that takes params inserts the
  collectives GSPMD inserts in the JAX package: a sum over ``model`` after
  ``wo`` and after ``w_down`` (in the model dtype), an all-gather of the
  embedding lookup along ``d_model``, and a sum of the tied unembedding's
  partial logits in f32 before the final softcap. Attention stays
  head-local where the axis divides both ``n_heads`` and ``n_kv_heads``;
  elsewhere (Gemma-2-2B's 8 and 4 heads over 8 ranks) each rank keeps the
  same flat slices of ``wq``/``wk``/``wv``, all-gathers the projections
  over ``model`` and attends only the whole heads its ``wo`` rows contract
  (:func:`_qkv`). Forward only: a tensor-parallel forward refuses a graph
  that needs gradients.
- **Sequence-parallel** (:func:`forward_seq_parallel`,
  :func:`run_with_cache_multi_seq_parallel`): the sequence split over
  ``data``, attention as an exact ring
  (:mod:`crosscoder_tpu_torch.parallel.ring_attention`), every other op
  position-local; the results come back stitched along the sequence on
  every rank.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.config import parse_hook_point
from crosscoder_tpu_torch.models.crosscoder import matmul_f32
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.dtypes import dtype_of

LMParams = dict[str, Any]


@dataclass(frozen=True)
class LMConfig:
    """Gemma-2 family architecture config."""

    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    attn_softcap: float = 50.0
    final_softcap: float = 30.0
    sliding_window: int = 4096
    query_pre_attn_scalar: float = 256.0
    dtype: str = "bf16"

    @classmethod
    def gemma2_2b(cls) -> "LMConfig":
        """Gemma-2-2B, the subject model pair (base vs IT)."""
        return cls(
            vocab_size=256_000, d_model=2304, n_layers=26, n_heads=8,
            n_kv_heads=4, head_dim=256, d_ff=9216, query_pre_attn_scalar=256.0,
        )

    @classmethod
    def gemma2_9b(cls) -> "LMConfig":
        """Gemma-2-9B (d_model 3584)."""
        return cls(
            vocab_size=256_000, d_model=3584, n_layers=42, n_heads=16,
            n_kv_heads=8, head_dim=256, d_ff=14_336, query_pre_attn_scalar=256.0,
        )

    @classmethod
    def gemma2_27b(cls) -> "LMConfig":
        """Gemma-2-27B: unlike 2B and 9B, its query scale is d_model /
        n_heads = 144, not head_dim."""
        return cls(
            vocab_size=256_000, d_model=4608, n_layers=46, n_heads=32,
            n_kv_heads=16, head_dim=128, d_ff=36_864, query_pre_attn_scalar=144.0,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 257, n_layers: int = 4) -> "LMConfig":
        """Test-sized config with the real model's hook semantics."""
        return cls(
            vocab_size=vocab_size, d_model=32, n_layers=n_layers, n_heads=4,
            n_kv_heads=2, head_dim=8, d_ff=64, sliding_window=8,
            query_pre_attn_scalar=8.0, dtype="fp32",
        )


_NAMED_CONFIGS = {
    "gemma-2-2b": LMConfig.gemma2_2b,
    "gemma-2-2b-it": LMConfig.gemma2_2b,
    "gemma-2-9b": LMConfig.gemma2_9b,
    "gemma-2-9b-it": LMConfig.gemma2_9b,
    "gemma-2-27b": LMConfig.gemma2_27b,
    "gemma-2-27b-it": LMConfig.gemma2_27b,
}


def config_for(model_name: str) -> LMConfig:
    """Architecture config by HF-style model name."""
    key = model_name.split("/")[-1].lower()
    if key not in _NAMED_CONFIGS:
        raise ValueError(f"unknown model {model_name!r}; known: {sorted(_NAMED_CONFIGS)}")
    return _NAMED_CONFIGS[key]()


# ---------------------------------------------------------------------------
# params


def init_params(cfg: LMConfig, *, seed: int = 0, device=None) -> LMParams:
    """Random-init params from ``seed`` (a ``torch.Generator`` on
    ``device``); layer leaves stacked on a leading ``[n_layers]`` axis.
    Runs on ``cuda`` unless ``device`` names another device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg.dtype)
    D, F, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    qd, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def nrm(shape, scale):
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):      # one slice at a time: no fp32 copy of a stacked leaf
            out[i] = (torch.randn(shape[1:], generator=gen, device=dev) * scale).to(dt)
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {
        "embed": (torch.randn((cfg.vocab_size, D), generator=gen, device=dev)
                  * D ** -0.5).to(dt),
        "final_norm": zeros(D),
        "layers": {
            "attn_norm": zeros(L, D),
            "post_attn_norm": zeros(L, D),
            "pre_ffw_norm": zeros(L, D),
            "post_ffw_norm": zeros(L, D),
            "wq": nrm((L, D, qd), D ** -0.5),
            "wk": nrm((L, D, kd), D ** -0.5),
            "wv": nrm((L, D, kd), D ** -0.5),
            "wo": nrm((L, qd, D), qd ** -0.5),
            "w_gate": nrm((L, D, F), D ** -0.5),
            "w_up": nrm((L, D, F), D ** -0.5),
            "w_down": nrm((L, F, D), F ** -0.5),
        },
    }


def _layer(params: LMParams, i: int) -> dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# tensor parallelism


TP_KEY = "tp"


@dataclass(frozen=True)
class TPGroup:
    """The ``model`` group a tensor-parallel param dict is split over (its
    ``"tp"`` entry) and this rank's index in it."""

    group: Any
    rank: int


def _tp(params: LMParams) -> TPGroup | None:
    return params.get(TP_KEY)


def _tp_group(mesh, axis: str = "model") -> TPGroup:
    return TPGroup(mesh.group(axis), mesh.index(axis))


def _tp_live(t: torch.Tensor) -> None:
    if t.requires_grad:
        raise NotImplementedError(
            "backward through a tensor-parallel LM forward is not ported: run it under "
            "torch.no_grad() (the harvest and the CE eval do)")


def _tp_sum(t: torch.Tensor, tp: TPGroup | None) -> torch.Tensor:
    """The partial products of a row-parallel matmul summed over the
    group, in ``t``'s dtype (the identity without a group)."""
    if tp is None:
        return t
    _tp_live(t)
    return coll.all_reduce_(t, tp.group)


def tp_shardings(mesh, axis: str = "model") -> dict:
    """Each leaf's shard under tensor parallelism over ``mesh``'s ``axis``,
    as :func:`crosscoder_tpu_torch.parallel.multihost.local_shard` takes
    it: ``(dim, axis size, this rank's index)`` in the stacked layout, or
    ``None`` for a leaf kept whole. The JAX ``tp_shardings`` layout: heads
    of ``wq``/``wk``/``wv`` and the hidden axis of ``w_gate``/``w_up``
    (their outputs), the contracting axis of ``wo``/``w_down``, the
    ``d_model`` axis of ``embed``; the norms whole."""
    n, i = mesh.size(axis), mesh.index(axis)

    def on(dim):
        return (dim, n, i)

    return {
        "embed": on(1),
        "final_norm": None,
        "layers": {
            "attn_norm": None, "post_attn_norm": None, "pre_ffw_norm": None,
            "post_ffw_norm": None,
            "wq": on(2), "wk": on(2), "wv": on(2), "wo": on(1),
            "w_gate": on(2), "w_up": on(2), "w_down": on(1),
        },
    }


def check_tp(cfg: LMConfig, m: int) -> None:
    """Raise :class:`ValueError` unless every leaf :func:`tp_shardings`
    cuts splits evenly over ``m`` model ranks: ``d_model``, ``d_ff`` and
    the flat q and k/v widths. Head counts the axis does not divide are
    taken (:func:`_qkv` gathers the heads a rank needs)."""
    for name, size in (("d_model", cfg.d_model), ("d_ff", cfg.d_ff),
                       ("the q width n_heads·head_dim", cfg.n_heads * cfg.head_dim),
                       ("the k/v width n_kv_heads·head_dim", cfg.n_kv_heads * cfg.head_dim)):
        if size % m:
            raise ValueError(f"tensor-parallel LM: {name} {size} must divide by {m}")


def shard_params_tp(params: LMParams, mesh, cfg: LMConfig, axis: str = "model") -> LMParams:
    """This rank's tensor-parallel slices of whole params (every rank holds
    the same), each in memory of its own, marked with the group
    (:class:`TPGroup`): every forward entry point takes the result
    unchanged."""
    from crosscoder_tpu_torch.parallel.multihost import local_shard

    check_tp(cfg, mesh.size(axis))
    whole = {k: v for k, v in params.items() if k != TP_KEY}
    out = local_shard(whole, tp_shardings(mesh, axis))
    out[TP_KEY] = _tp_group(mesh, axis)
    return out


# ---------------------------------------------------------------------------
# numerics


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm: fp32 compute, (1 + w) scale."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(x.dtype)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE on ``x [B, S, n, hd]``; ``positions`` is ``[S]``
    (shared) or ``[B, S]`` (per token, the paged plane)."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d // 2, dtype=torch.float32,
                                          device=x.device) * 2.0 / d))
    ang = positions.float()[..., None] * freqs                 # [(B,) S, d/2]
    cos = torch.cos(ang).unsqueeze(-2)                         # [(B,) S, 1, d/2]
    sin = torch.sin(ang).unsqueeze(-2)
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _qkv(x: torch.Tensor, lp, cfg: LMConfig, pos: torch.Tensor, tp: TPGroup | None = None):
    """Project + RoPE: ``(q [B,S,H,hd], k/v [B,S,KV,hd], keep)``, the heads
    this rank attends. ``keep`` is ``None`` when the attention output is
    what this rank's ``wo`` rows contract whole, else the ``(lo, hi)``
    columns of it they do.

    Tensor-parallel, each rank holds a contiguous slice of the flat q and
    k/v widths (JAX's layout). Where ``m`` divides both head counts the
    slices are whole head groups and attention is head-local. Elsewhere the
    projections are all-gathered over ``model`` and the rank attends the
    whole query heads that cover its ``wo`` rows, against the KV heads
    they read: a whole GQA group's when its heads start and end on group
    boundaries, else one KV head a query head (a group of 1)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = (torch.matmul(x, lp[w]) for w in ("wq", "wk", "wv"))
    m = 1 if tp is None else coll.group_size(tp.group)
    H, KV = q.shape[-1] * m // hd, k.shape[-1] * m // hd            # the model's heads
    keep = None
    if H % m or KV % m:
        _tp_live(q)
        q, k, v = (coll.all_gather_cat(t, t.dim() - 1, tp.group) for t in (q, k, v))
        lo, hi = tp.rank * q.shape[-1] // m, (tp.rank + 1) * q.shape[-1] // m
        h0, h1 = lo // hd, -(-hi // hd)
        g = H // KV
        if h0 % g == 0 and h1 % g == 0:
            kv = torch.arange(h0 // g, h1 // g, device=x.device)
        else:
            kv = torch.arange(h0, h1, device=x.device) // g
        q = q.reshape(B, S, H, hd)[:, :, h0:h1]
        k, v = (t.reshape(B, S, KV, hd).index_select(2, kv) for t in (k, v))
        keep = (lo - h0 * hd, hi - h0 * hd)
    else:
        H, KV = H // m, KV // m                                     # this rank's heads
        q, k, v = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)
    return _rope(q, pos, cfg.rope_theta), _rope(k, pos, cfg.rope_theta), v, keep


def _mlp(x: torch.Tensor, lp, tp: TPGroup | None = None) -> torch.Tensor:
    """GeGLU: gelu_tanh(x·W_gate) ⊙ (x·W_up) · W_down (the partial
    products summed over ``tp``)."""
    gate = torch.matmul(x, lp["w_gate"]).float()
    up = torch.matmul(x, lp["w_up"]).float()
    h = (torch.nn.functional.gelu(gate, approximate="tanh") * up).to(x.dtype)
    return _tp_sum(torch.matmul(h, lp["w_down"]), tp)


def _embed(params: LMParams, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    dt = dtype_of(cfg.dtype)
    # made on the device: a host tensor copied to the card would sync the
    # stream, and the refill dispatcher must queue quanta ahead of the card
    scale = torch.full((), math.sqrt(cfg.d_model), dtype=dt, device=tokens.device)
    e = params["embed"][tokens]
    tp = _tp(params)
    if tp is not None:                  # this rank's d_model columns, gathered
        _tp_live(e)
        e = coll.all_gather_cat(e, e.dim() - 1, tp.group)
    return e.to(dt) * scale


# ---------------------------------------------------------------------------
# hooks

_SITE_RESID, _SITE_ATTN, _SITE_MLP = 0, 1, 2


def _hook_layers(cfg: LMConfig, hook_points: Sequence[str]) -> tuple[tuple[int, int], ...]:
    """Hook strings → capture ``(layer, site)`` pairs: ``resid_pre`` of L is
    the stream entering block L, ``resid_post`` of L is ``resid_pre`` of
    L+1, ``attn_out``/``mlp_out`` of L are block L's contributions as added
    to the stream."""
    pairs = []
    for hp in hook_points:
        layer, site = parse_hook_point(hp)
        if site == "resid_pre":
            code = _SITE_RESID
        elif site == "resid_post":
            layer, code = layer + 1, _SITE_RESID
        elif site == "attn_out":
            code = _SITE_ATTN
        elif site == "mlp_out":
            code = _SITE_MLP
        else:
            raise ValueError(
                f"unsupported hook site {site!r} "
                "(resid_pre/resid_post/attn_out/mlp_out)"
            )
        max_layer = cfg.n_layers if code == _SITE_RESID else cfg.n_layers - 1
        if not 0 <= layer <= max_layer:
            raise ValueError(f"hook layer {layer} out of range for {cfg.n_layers}-layer model")
        pairs.append((layer, code))
    return tuple(pairs)


def _scan_stop(pairs: tuple[tuple[int, int], ...]) -> int:
    """Blocks that must run for every capture to be observable: a resid
    slot at L needs blocks [0, L); a sublayer slot at L needs block L."""
    return max(
        (layer + (1 if code != _SITE_RESID else 0) for layer, code in pairs),
        default=0,
    )


def _capture(buf: torch.Tensor, x: torch.Tensor, i: int, pairs, site: int) -> None:
    # the JAX package accumulates a one-hot FMA into every slot; writing
    # the matching slot of the zero buffer directly gives the same values
    for s, (layer, code) in enumerate(pairs):
        if layer == i and code == site:
            buf[s] = x


# ---------------------------------------------------------------------------
# edits


def splice_edit(resid: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Replace every post-BOS position with ``value``'s, keep position 0
    (the reference's ``splice_act_hook``)."""
    return torch.cat([resid[:, :1], value[:, 1:].to(resid.dtype)], dim=1)


def zero_edit(resid: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Zero the whole hook activation (the reference's
    ``zero_ablation_hook``)."""
    del value
    return torch.zeros_like(resid)


def replace_edit(resid: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Replace the whole hook activation with ``value``."""
    return value.to(resid.dtype)


@dataclass(frozen=True)
class Edit:
    """An intervention at one hook point: ``fn(resid, value) -> resid``,
    shape-preserving; ``value`` is ``[B, S, d_model]`` (zeros when None)."""

    hook_point: str
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    value: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# forwards


AttentionFn = Callable[..., torch.Tensor]


def _run_blocks(params, resid, cfg: LMConfig, pairs, n_scan: int,
                attend: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor],
                pos: torch.Tensor, edits=()) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocks ``[0, n_scan)`` on ``resid [R, S, D]``; ``attend(q, k, v,
    window)`` maps projected heads to ``[R, S, H*hd]``. ``edits``: ``(layer,
    site, fn, value)`` tuples, each applied at its hook before that hook's
    capture (a sublayer edit before the contribution joins the stream).
    Returns the final stream and the capture buffer ``[n_cap, R, S, D]``."""
    buf = torch.zeros((len(pairs),) + tuple(resid.shape), dtype=resid.dtype,
                      device=resid.device)
    resid = _run_layers(params, resid, buf, cfg, pairs, 0, n_scan, attend, pos, edits)
    resid = _edited(edits, resid, n_scan, _SITE_RESID)
    _capture(buf, resid, n_scan, pairs, _SITE_RESID)
    return resid, buf


def _edited(edits, x: torch.Tensor, i: int, site: int) -> torch.Tensor:
    for layer, code, fn, value in edits:
        if layer == i and code == site:
            x = fn(x, value)
    return x


def _run_layers(params, resid, buf, cfg: LMConfig, pairs, lo: int, hi: int, attend,
                pos: torch.Tensor, edits=()) -> torch.Tensor:
    """Blocks ``[lo, hi)`` of :func:`_run_blocks`, capturing into ``buf``;
    returns the stream after block ``hi - 1``. The segmented harvest runs
    the same blocks a range at a time, so its result is bitwise the whole
    loop's."""
    want_attn = any(c == _SITE_ATTN for _, c in pairs)
    want_mlp = any(c == _SITE_MLP for _, c in pairs)
    tp = _tp(params)
    for i in range(lo, hi):
        lp = _layer(params, i)
        resid = _edited(edits, resid, i, _SITE_RESID)
        _capture(buf, resid, i, pairs, _SITE_RESID)
        window = cfg.sliding_window if i % 2 == 0 else 0    # even layers: local
        q, k, v, keep = _qkv(_rms_norm(resid, lp["attn_norm"], cfg.rms_eps), lp, cfg, pos, tp)
        o = attend(q, k, v, window)
        if keep is not None:            # the columns this rank's wo rows contract
            o = o[..., keep[0]:keep[1]]
        a = _tp_sum(torch.matmul(o, lp["wo"]), tp)
        attn_out = _edited(edits, _rms_norm(a, lp["post_attn_norm"], cfg.rms_eps), i, _SITE_ATTN)
        if want_attn:
            _capture(buf, attn_out, i, pairs, _SITE_ATTN)
        resid = resid + attn_out
        m = _mlp(_rms_norm(resid, lp["pre_ffw_norm"], cfg.rms_eps), lp, tp)
        mlp_out = _edited(edits, _rms_norm(m, lp["post_ffw_norm"], cfg.rms_eps), i, _SITE_MLP)
        if want_mlp:
            _capture(buf, mlp_out, i, pairs, _SITE_MLP)
        resid = resid + mlp_out
    return resid


def _padded_attend(cfg: LMConfig):
    """The padded forward's attention: the plain masked softmax over the
    whole row."""
    scale = cfg.query_pre_attn_scalar ** -0.5

    def attend(q, k, v, window):
        return pa.ragged_attention_reference(
            q, k, v, None, scale=scale, softcap=cfg.attn_softcap,
            window=cfg.sliding_window, is_local=bool(window))

    return attend


def _unembed(params: LMParams, resid: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Final RMSNorm → tied unembedding (summed in f32, f32 out) → final
    softcap; tensor-parallel, each rank's ``d_model`` columns give partial
    logits, summed over the group in f32."""
    x = _rms_norm(resid, params["final_norm"], cfg.rms_eps)
    tp = _tp(params)
    w = params["embed"]
    if tp is not None:
        cols = w.shape[1]
        x = x[..., tp.rank * cols:(tp.rank + 1) * cols]
    logits = matmul_f32(x.reshape(-1, w.shape[1]), w.t())
    logits = _tp_sum(logits.reshape(*x.shape[:-1], -1), tp)
    return _softcap(logits, cfg.final_softcap) if cfg.final_softcap else logits


def forward(params: LMParams, tokens, cfg: LMConfig, *, capture: Sequence[str] = (),
            edits: Sequence[Edit] = (), return_logits: bool = True
            ) -> tuple[torch.Tensor | None, dict[str, torch.Tensor]]:
    """The padded forward: ``(logits [B, S, vocab] f32 or None, cache)``.

    ``capture``: hook points to record, each ``[B, S, d_model]`` in the
    cache. ``edits``: interventions applied before capture at the same
    hook; residual sites edit the stream, ``attn_out``/``mlp_out`` sites
    that sublayer's contribution before it joins the stream.
    ``return_logits=False`` runs only the blocks below the highest hook or
    edit and skips the unembedding. Differentiable (no ``no_grad``)."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    cap_pairs = _hook_layers(cfg, tuple(capture))
    edit_pairs = _hook_layers(cfg, [e.hook_point for e in edits])
    zeros = None
    ed = []
    for (layer, code), e in zip(edit_pairs, edits):
        value = e.value
        if value is None:
            if zeros is None:
                zeros = torch.zeros(tuple(tokens.shape) + (cfg.d_model,),
                                    dtype=dtype_of(cfg.dtype), device=tokens.device)
            value = zeros
        ed.append((layer, code, e.fn, value))
    # without logits, nothing above the highest hooked layer is observable
    n_scan = (cfg.n_layers if return_logits
              else min(cfg.n_layers, max(_scan_stop(cap_pairs), _scan_stop(edit_pairs))))
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    resid, buf = _run_blocks(params, _embed(params, tokens, cfg), cfg, cap_pairs, n_scan,
                             _padded_attend(cfg), pos, ed)
    logits = _unembed(params, resid, cfg) if return_logits else None
    return logits, {hp: buf[i] for i, hp in enumerate(capture)}


def loss_fn(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy (f32)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = torch.as_tensor(tokens, device=logits.device).long()[:, 1:]
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()


def run_with_cache(params: LMParams, tokens, cfg: LMConfig,
                   hook_points: Sequence[str]) -> dict[str, torch.Tensor]:
    """Capture-only forward (no unembedding)."""
    return forward(params, tokens, cfg, capture=hook_points, return_logits=False)[1]


def ce_loss(params: LMParams, tokens, cfg: LMConfig, edits: Sequence[Edit] = ()
            ) -> torch.Tensor:
    """CE of a (possibly edited) forward: one f32 scalar on the device."""
    logits, _ = forward(params, tokens, cfg, edits=edits)
    return loss_fn(logits, tokens)


@torch.no_grad()
def run_with_cache_multi(params_seq: Sequence[LMParams], tokens: torch.Tensor,
                         cfg: LMConfig, hook_points: Sequence[str]) -> torch.Tensor:
    """All models' captures through the PADDED forward:
    ``[B, S, n_models·n_hooks, d_model]``, source axis model-major. Attention
    is the plain masked softmax over the whole padded row."""
    pairs = _hook_layers(cfg, tuple(hook_points))
    n_scan = min(cfg.n_layers, _scan_stop(pairs))
    tokens = torch.as_tensor(tokens, device=params_seq[0]["embed"].device).long()
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    outs = []
    for p in params_seq:
        _, buf = _run_blocks(p, _embed(p, tokens, cfg), cfg, pairs, n_scan,
                             _padded_attend(cfg), pos)
        outs.extend(buf[i] for i in range(len(pairs)))
    return torch.stack(outs, dim=2)


@torch.no_grad()
def paged_capture(params_seq: Sequence[LMParams], chunk, cfg: LMConfig,
                  hook_points: Sequence[str], page_size: int, *,
                  attention: AttentionFn = pa.paged_attention) -> torch.Tensor:
    """All models' captures through the PAGED forward for a packed chunk
    (:class:`crosscoder_tpu_torch.data.paging.PackedChunk`):
    ``[D, seq_len, n_models·n_hooks, d_model]``, source axis model-major,
    positions at ``t >= lengths[d]`` zeroed.

    Every position-local op runs on the dense ``[R, S]`` token plane;
    attention runs per document: heads are gathered through ``doc_idx``
    into per-document buffers, attended by ``attention`` (the ragged paged
    attention wrapper, whose page loop is bounded by ``ceil(len/page)``)
    and scattered back through ``plane_idx``. ``attention`` takes
    :func:`crosscoder_tpu_torch.ops.paged_attention.paged_attention`'s
    signature; passing its plain version re-runs the path without the
    kernel.
    """
    dev = params_seq[0]["embed"].device
    pairs = _hook_layers(cfg, tuple(hook_points))
    n_scan = min(cfg.n_layers, _scan_stop(pairs))
    plane = torch.as_tensor(np.asarray(chunk.tokens, np.int64), device=dev)
    pos2d = torch.as_tensor(chunk.pos, device=dev)
    doc_idx = torch.as_tensor(np.asarray(chunk.doc_idx, np.int64), device=dev)
    plane_idx = torch.as_tensor(np.asarray(chunk.plane_idx, np.int64), device=dev)
    lengths = torch.as_tensor(np.asarray(chunk.lengths, np.int32), device=dev)
    R, Sp = plane.shape
    D, S = doc_idx.shape
    scale = cfg.query_pre_attn_scalar ** -0.5

    def attend(q, k, v, window):
        def gather_docs(x):          # [R, Sp, ...] -> [D, S, ...]
            return x.reshape((R * Sp,) + tuple(x.shape[2:]))[doc_idx]

        a = attention(gather_docs(q), gather_docs(k), gather_docs(v), lengths,
                      page_size=page_size, scale=scale, softcap=cfg.attn_softcap,
                      window=window)
        return a.reshape(D * S, -1)[plane_idx]               # -> [R, Sp, H*hd]

    outs = []
    for p in params_seq:
        _, buf = _run_blocks(p, _embed(p, plane, cfg), cfg, pairs, n_scan, attend, pos2d)
        flat = buf.reshape(len(pairs), R * Sp, cfg.d_model)
        outs.extend(flat[i][doc_idx] for i in range(len(pairs)))   # [D, S, d]
    out = torch.stack(outs, dim=2)                                 # [D, S, n_src, d]
    valid = torch.arange(S, device=dev)[None] < lengths[:, None].long()
    return torch.where(valid[:, :, None, None], out, torch.zeros((), dtype=out.dtype, device=dev))


@torch.no_grad()
def run_with_cache_multi_paged(params_seq: Sequence[LMParams], tokens, lengths, cfg: LMConfig,
                               hook_points: Sequence[str], *, page_size: int,
                               n_rows: int | None = None, row_multiple: int = 1,
                               pad_mode: str = "zero", out_dtype: torch.dtype | None = None,
                               attention: AttentionFn | None = None) -> torch.Tensor:
    """All models' captures through the PAGED runtime: documents ``tokens
    [D, seq_len]`` (padded layout) with ``lengths [D]`` are packed on the
    host into a dense token plane (:func:`crosscoder_tpu_torch.data.paging.pack_chunk`,
    ``n_rows``/``row_multiple`` as there), run through :func:`paged_capture`
    (ragged attention through ``attention``, by default
    :func:`~crosscoder_tpu_torch.ops.paged_attention.paged_attention`: K1
    on the card) and unpacked
    to ``[D, seq_len, n_models·n_hooks, d_model]``, source axis
    model-major, as :func:`run_with_cache_multi` returns. Positions at
    ``t >= lengths[d]`` are zeros (``pad_mode="zero"``) or cycle the
    document's own post-BOS rows (``"wrap"``, the replay buffer's choice:
    ``src = t`` below the length, else ``1 + (t - 1) % max(len - 1, 1)``,
    and 0 for a single-token document), so no row is all zeros.

    On an all-full-length chunk the packing is the identity, and with the
    plain attention the result is bitwise :func:`run_with_cache_multi`'s.
    """
    from crosscoder_tpu_torch.data import paging

    if pad_mode not in ("zero", "wrap"):
        raise ValueError(f"pad_mode must be zero|wrap, got {pad_mode!r}")
    chunk = paging.pack_chunk(np.asarray(tokens), np.asarray(lengths), n_rows=n_rows,
                              row_multiple=row_multiple)
    out = paged_capture(params_seq, chunk, cfg, hook_points, page_size,
                        attention=attention or pa.paged_attention)
    if pad_mode == "wrap":
        S = out.shape[1]
        t = torch.arange(S, device=out.device)[None]                       # [1, S]
        ln = torch.as_tensor(chunk.lengths, device=out.device).long()[:, None]
        src = torch.where(t < ln, t, 1 + (t - 1) % torch.clamp(ln - 1, min=1))
        src = torch.where((t >= ln) & (ln == 1), torch.zeros_like(src), src)
        out = torch.take_along_dim(out, src[:, :, None, None], dim=1)
    return out.to(out_dtype) if out_dtype is not None else out


# ---------------------------------------------------------------------------
# segmented harvest (dispatch quanta for the replay buffer's refill)


class SegmentedHarvest:
    """:func:`run_with_cache_multi` as a sequence of small dispatches: each
    model's capture forward cut into ``seg_layers()``-block quanta, so the
    replay buffer can spread a chunk's harvest evenly over the train steps
    that share the card's stream instead of queueing a whole chunk's
    forwards behind one step (the refill bubble).

    ``step()`` dispatches one quantum (asynchronous on the card; nothing
    waits) and returns False once the stacked result has been dispatched;
    ``step_many(q)`` advances up to ``q`` quanta, one block loop over the
    same model's consecutive quanta, with ``step()``'s accounting;
    ``result()`` dispatches what is left and returns the ``[B, S,
    n_sources, d_model]`` capture (in ``out_dtype`` when given). The blocks
    run the whole forward's ops in its order (:func:`_run_layers`), so the
    result is bitwise :func:`run_with_cache_multi`'s.

    ``SEG_LAYERS`` None reads ``$CROSSCODER_SEG_LAYERS`` at use time
    (default 3); an int set on the class overrides it.
    """

    SEG_LAYERS: int | None = None

    @classmethod
    def seg_layers(cls) -> int:
        if cls.SEG_LAYERS is not None:
            return cls.SEG_LAYERS
        return int(os.environ.get("CROSSCODER_SEG_LAYERS", "3"))

    @classmethod
    def count(cls, cfg: LMConfig, hook_points: Sequence[str], n_models: int) -> int:
        """``step()`` calls a job over these hooks needs (for pacing)."""
        n_scan = min(cfg.n_layers, _scan_stop(_hook_layers(cfg, tuple(hook_points))))
        return n_models * max(1, -(-n_scan // cls.seg_layers()))

    def __init__(self, params_seq: Sequence[LMParams], tokens, cfg: LMConfig,
                 hook_points: Sequence[str], out_dtype: torch.dtype | None = None) -> None:
        self.params_seq = tuple(params_seq)
        self.tokens = torch.as_tensor(tokens, device=self.params_seq[0]["embed"].device).long()
        self.cfg = cfg
        self.capture = _hook_layers(cfg, tuple(hook_points))
        self.n_scan = min(cfg.n_layers, _scan_stop(self.capture))
        self.out_dtype = out_dtype
        # the granularity is fixed for the job's life: n_steps (the pacing
        # denominator) and the quantum width must agree
        self._seg_layers = self.seg_layers()
        self.n_steps = self.count(cfg, hook_points, len(self.params_seq))
        self._pos = torch.arange(self.tokens.shape[1], device=self.tokens.device)
        self._attend = _padded_attend(cfg)
        self._model_idx = 0
        self._lo = 0
        self._resid = self._buf = None
        self._bufs: list[torch.Tensor] = []
        self._out = None

    def inflight(self) -> list[torch.Tensor]:
        """Tensors dispatched whose values may still be computing."""
        return [x for x in (self._resid, self._buf, self._out) if x is not None]

    def _start_model(self) -> None:
        p = self.params_seq[self._model_idx]
        self._resid = _embed(p, self.tokens, self.cfg)
        self._buf = torch.zeros((len(self.capture),) + tuple(self._resid.shape),
                                dtype=self._resid.dtype, device=self._resid.device)

    def _scan(self, k: int) -> None:
        self._resid = _run_layers(self.params_seq[self._model_idx], self._resid, self._buf,
                                  self.cfg, self.capture, self._lo, self._lo + k,
                                  self._attend, self._pos)
        self._lo += k

    def _end_model(self) -> bool:
        """Close the model whose blocks are done; True once every model is."""
        _capture(self._buf, self._resid, self.n_scan, self.capture, _SITE_RESID)
        self._bufs.append(self._buf)
        self._resid = self._buf = None
        self._lo = 0
        self._model_idx += 1
        if self._model_idx < len(self.params_seq):
            return False
        out = torch.stack([b[i] for b in self._bufs for i in range(b.shape[0])], dim=2)
        self._out = out.to(self.out_dtype) if self.out_dtype is not None else out
        self._bufs = []
        return True

    @torch.no_grad()
    def step(self) -> bool:
        """Dispatch the next quantum; False once fully dispatched."""
        if self._out is not None:
            return False
        if self._resid is None:
            self._start_model()
        if self._lo < self.n_scan:
            self._scan(min(self._seg_layers, self.n_scan - self._lo))
        return not (self._lo >= self.n_scan and self._end_model())

    @torch.no_grad()
    def step_many(self, quanta: int) -> tuple[int, bool]:
        """Advance by up to ``quanta`` quanta; ``(quanta used, alive)`` with
        the accounting of as many :meth:`step` calls."""
        used = 0
        while used < quanta:
            if self._out is not None:
                return used, False
            if self._resid is None:
                self._start_model()
            if self._lo < self.n_scan:
                n_q = min(quanta - used, -(-(self.n_scan - self._lo) // self._seg_layers))
                self._scan(min(n_q * self._seg_layers, self.n_scan - self._lo))
                used += n_q
            if self._lo >= self.n_scan and self._end_model():
                return used, False
        return used, True

    def result(self) -> torch.Tensor:
        while self._out is None:
            self.step()
        return self._out


# ---------------------------------------------------------------------------
# sequence-parallel forward (long-context harvest)


def _check_seq_divisible(tokens: torch.Tensor, n: int) -> None:
    if tokens.shape[1] % n:
        raise ValueError(f"seq len {tokens.shape[1]} not divisible by {n} sequence shards")


def _ring_attend(cfg: LMConfig, group, n: int):
    """The sequence-parallel forward's attention: the ring over ``group``."""
    from crosscoder_tpu_torch.parallel.ring_attention import ring_attention

    scale = cfg.query_pre_attn_scalar ** -0.5

    def attend(q, k, v, window):
        B, S = q.shape[:2]
        return ring_attention(q, k, v, group=group, n_shards=n, scale=scale,
                              softcap=cfg.attn_softcap, sliding_window=cfg.sliding_window,
                              is_local=bool(window)).reshape(B, S, -1)

    return attend


def _seq_local(params: LMParams, tokens, cfg: LMConfig, mesh, axis_name: str, pairs,
               n_scan: int):
    """This rank's blocks over its slice of the sequence: ``(resid, buf,
    group)`` with the stream and the capture buffer ``[n_cap, B, S/n, D]``
    of positions ``[r·S/n, (r+1)·S/n)``."""
    tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
    n, r, group = mesh.size(axis_name), mesh.index(axis_name), mesh.group(axis_name)
    _check_seq_divisible(tokens, n)
    Sl = tokens.shape[1] // n
    tok = tokens[:, r * Sl:(r + 1) * Sl]
    pos = r * Sl + torch.arange(Sl, device=tok.device)
    resid, buf = _run_blocks(params, _embed(params, tok, cfg), cfg, pairs, n_scan,
                             _ring_attend(cfg, group, n), pos)
    return resid, buf, group


@torch.no_grad()
def forward_seq_parallel(params: LMParams, tokens, cfg: LMConfig, mesh, *,
                         axis_name: str = "data", capture: Sequence[str] = (),
                         return_logits: bool = False
                         ) -> tuple[torch.Tensor | None, dict[str, torch.Tensor]]:
    """:func:`forward` with the SEQUENCE axis split over ``mesh``'s
    ``axis_name`` (a :class:`crosscoder_tpu_torch.parallel.mesh.Mesh`):
    every rank passes the whole ``tokens [B, S]`` (``S`` divisible by the
    axis, else :class:`ValueError`) and runs the blocks over its slice,
    attention as an exact ring. Without logits the blocks stop at the
    highest hooked layer. Returns ``(logits [B, S, vocab] f32 or None,
    cache)`` stitched along the sequence on every rank (one all-gather
    each). Edits are not supported, as in the JAX package."""
    pairs = _hook_layers(cfg, tuple(capture))
    n_scan = cfg.n_layers if return_logits else min(cfg.n_layers, _scan_stop(pairs))
    resid, buf, group = _seq_local(params, tokens, cfg, mesh, axis_name, pairs, n_scan)
    logits = None
    if return_logits:
        logits = coll.all_gather_cat(_unembed(params, resid, cfg), 1, group)
    if pairs:
        buf = coll.all_gather_cat(buf, 2, group)
    return logits, {hp: buf[i] for i, hp in enumerate(capture)}


@torch.no_grad()
def run_with_cache_multi_seq_parallel(params_seq: Sequence[LMParams], tokens, cfg: LMConfig,
                                      hook_points: Sequence[str], mesh, *,
                                      axis_name: str = "data") -> torch.Tensor:
    """All models' captures with the SEQUENCE axis split over ``mesh``'s
    ``axis_name`` (ring attention): ``[B, S, n_models·n_hooks, d_model]``,
    source axis model-major, the shape and order of
    :func:`run_with_cache_multi`, stitched on every rank (one all-gather)."""
    pairs = _hook_layers(cfg, tuple(hook_points))
    n_scan = min(cfg.n_layers, _scan_stop(pairs))
    outs = []
    group = None
    for p in params_seq:
        _, buf, group = _seq_local(p, tokens, cfg, mesh, axis_name, pairs, n_scan)
        outs.extend(buf[i] for i in range(len(pairs)))
    return coll.all_gather_cat(torch.stack(outs, dim=2), 1, group)


# ---------------------------------------------------------------------------
# weight loading


def from_torch_state_dict(sd: Mapping[str, Any], cfg: LMConfig, dtype: str | None = None,
                          device=None, tp=None) -> LMParams:
    """Params from an HF-transformers Gemma2 ``state_dict`` (tensors or
    numpy arrays): HF projections ``[out, in]`` become stacked ``[in,
    out]`` leaves. Each leaf goes to ``device`` in its stored dtype, to f32
    there, and is rounded once to ``dtype`` (default ``cfg.dtype``), so the
    values are the JAX package's (f32 on the host, then cast) whichever
    device converts. ``tp``: a mesh whose ``model`` axis the params are
    tensor-parallel over; each matrix is cut to this rank's slice
    (:func:`tp_shardings`) before it moves, so the whole model never lands
    on one device, and the result equals :func:`shard_params_tp` of the
    whole params. Runs on ``cuda`` unless ``device`` names another
    device."""
    dev = resolve_device(device)
    dt = dtype_of(dtype or cfg.dtype)
    specs = None
    if tp is not None:
        check_tp(cfg, tp.size("model"))
        specs = tp_shardings(tp)

    def get(name: str, spec=None, transpose: bool = False) -> torch.Tensor:
        v = sd[name]
        t = v.detach() if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
        t = t.t() if transpose else t
        if spec is not None:            # (dim, n, i) of this leaf
            dim, n, i = spec
            w = t.shape[dim] // n
            t = t.narrow(dim, i * w, w)
        return t.to(dev).float()

    def leaf(name: str, key: str) -> torch.Tensor:
        return get(name, specs and specs[key]).to(dt)

    def stack(key: str, fmt: str, transpose: bool) -> torch.Tensor:
        spec = specs and specs["layers"][key]
        if spec is not None:            # the layer axis leads the stacked leaf
            spec = (spec[0] - 1, spec[1], spec[2])
        out = None
        for i in range(cfg.n_layers):
            m = get(fmt.format(i), spec, transpose)
            if out is None:
                out = torch.empty((cfg.n_layers,) + tuple(m.shape), dtype=dt, device=dev)
            out[i] = m                      # one rounding to dt
        return out

    p = "model.layers.{}."
    params = {
        "embed": leaf("model.embed_tokens.weight", "embed"),
        "final_norm": leaf("model.norm.weight", "final_norm"),
        "layers": {
            "attn_norm": stack("attn_norm", p + "input_layernorm.weight", False),
            "post_attn_norm": stack("post_attn_norm", p + "post_attention_layernorm.weight",
                                    False),
            "pre_ffw_norm": stack("pre_ffw_norm", p + "pre_feedforward_layernorm.weight",
                                  False),
            "post_ffw_norm": stack("post_ffw_norm", p + "post_feedforward_layernorm.weight",
                                   False),
            "wq": stack("wq", p + "self_attn.q_proj.weight", True),
            "wk": stack("wk", p + "self_attn.k_proj.weight", True),
            "wv": stack("wv", p + "self_attn.v_proj.weight", True),
            "wo": stack("wo", p + "self_attn.o_proj.weight", True),
            "w_gate": stack("w_gate", p + "mlp.gate_proj.weight", True),
            "w_up": stack("w_up", p + "mlp.up_proj.weight", True),
            "w_down": stack("w_down", p + "mlp.down_proj.weight", True),
        },
    }
    if tp is not None:
        params[TP_KEY] = _tp_group(tp)
    return params


def from_hf(path: str, cfg: LMConfig | None = None, device=None, tp=None
            ) -> tuple[LMParams, LMConfig]:
    """``(params, cfg)`` of a Gemma-2 checkpoint in a LOCAL HF directory
    (``save_pretrained`` layout), read by ``transformers`` in bf16 with
    ``local_files_only``; the hub is never asked. ``cfg`` None maps the
    checkpoint's own config. ``tp``: a mesh to load tensor-parallel over
    its ``model`` axis, this rank's slices only
    (:func:`from_torch_state_dict`). Runs on ``cuda`` unless ``device``
    names another device. :class:`ValueError` when ``path`` is not a
    directory."""
    if not Path(path).is_dir():
        raise ValueError(
            f"from_hf loads a local HF checkpoint directory, and {path!r} is not one "
            f"(the port downloads nothing: save the model with save_pretrained first)")
    dev = resolve_device(device)
    import transformers  # deferred: heavyweight, and only this loader needs it

    model = transformers.AutoModelForCausalLM.from_pretrained(
        path, dtype=torch.bfloat16, local_files_only=True)
    hf = model.config
    if cfg is None:
        cfg = LMConfig(
            vocab_size=hf.vocab_size, d_model=hf.hidden_size, n_layers=hf.num_hidden_layers,
            n_heads=hf.num_attention_heads, n_kv_heads=hf.num_key_value_heads,
            head_dim=hf.head_dim, d_ff=hf.intermediate_size, rope_theta=hf.rope_theta,
            rms_eps=hf.rms_norm_eps, attn_softcap=hf.attn_logit_softcapping,
            final_softcap=hf.final_logit_softcapping, sliding_window=hf.sliding_window,
            query_pre_attn_scalar=float(hf.query_pre_attn_scalar))
    return from_torch_state_dict(model.state_dict(), cfg, device=dev, tp=tp), cfg

"""Ring attention: exact causal attention over a sequence split across
ranks, ported from :mod:`crosscoder_tpu.parallel.ring_attention`.

Each rank of a group holds one block of the sequence (rank ``r`` positions
``[r·S, (r+1)·S)``): its queries and the K/V block it currently holds.
:func:`fold_block` folds one K/V block into the online-softmax state
(running max ``m``, denominator ``l``, unnormalized output ``o``, all f32);
:func:`ring_attention` folds the rank's own block, passes its K/V to the
next rank while it folds, and after ``n - 1`` hops has folded every block,
the last one after the final hop (no wasted ``n``-th hop). The result is
full attention, not an approximation, while no rank holds more than
``S·S`` of the score matrix.

The semantics are Gemma-2's (:func:`crosscoder_tpu_torch.models.lm._qkv`
and the padded forward's attention): GQA with the group folded into the
queries, the logit softcap, the causal mask and, on local layers, the
sliding window. Masked logits take ``_NEG`` (finite, so a fully masked
block stays NaN-free) and ``p`` is masked again, so such a block adds
nothing.

Not a hand-written kernel, as the JAX module is not a Pallas kernel: the
block products are matmuls, and the transport is one batched
``isend``/``irecv`` of K and V a hop
(:func:`crosscoder_tpu_torch.parallel.collectives.ring_shift_start`),
started before the fold and waited for after it. A group of one rank (or
``None``) folds its one block and sends nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from crosscoder_tpu_torch.parallel import collectives as coll

_NEG = -1e30  # mask value; kept finite so fully-masked blocks stay NaN-free


def init_state(B: int, Sq: int, KV: int, g: int, hd: int, device) -> tuple[torch.Tensor, ...]:
    """The empty online-softmax state ``(m, l, o)``: ``m``/``l`` ``[B, KV,
    g, Sq]`` and ``o [B, KV, g, Sq, hd]``, f32."""
    m = torch.full((B, KV, g, Sq), _NEG, dtype=torch.float32, device=device)
    l = torch.zeros((B, KV, g, Sq), dtype=torch.float32, device=device)
    o = torch.zeros((B, KV, g, Sq, hd), dtype=torch.float32, device=device)
    return m, l, o


def scaled_queries(q: torch.Tensor, n_kv: int, scale: float) -> torch.Tensor:
    """``q [B, Sq, H, hd]`` grouped by KV head and scaled in f32, then
    rounded back to ``q``'s dtype, as the JAX ring does: ``[B, Sq, KV, g,
    hd]``."""
    B, Sq, H, hd = q.shape
    return (q.reshape(B, Sq, n_kv, H // n_kv, hd).float() * scale).to(q.dtype)


def fold_block(m, l, o, qg, q_pos, k, v, k_pos, *, softcap: float = 0.0,
               sliding_window: int = 0, is_local: bool = False):
    """Fold one K/V block into the state: ``qg`` from :func:`scaled_queries`
    at positions ``q_pos [Sq]``, ``k``/``v [B, Sk, KV, hd]`` at ``k_pos
    [Sk]``. Products of the operands' values summed in f32, the softmax
    weights kept in f32; returns the new ``(m, l, o)``."""
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    causal = q_pos[:, None] >= k_pos[None, :]                   # [Sq, Sk]
    mask = causal & (q_pos[:, None] - k_pos[None, :] < sliding_window) if is_local else causal
    mask5 = mask[None, None, None]
    neg = torch.full((), _NEG, dtype=torch.float32, device=logits.device)
    logits = torch.where(mask5, logits, neg)
    new_m = torch.maximum(m, logits.amax(dim=-1))
    # re-masked: a fully masked block has logits == _NEG == new_m and
    # would otherwise add exp(0) = 1 an entry
    p = torch.exp(logits - new_m[..., None]) * mask5
    corr = torch.exp(m - new_m)
    l = l * corr + p.sum(dim=-1)
    # p stays f32 (the JAX ring rounds it to v's dtype for the MXU; the
    # products here sum in f32 either way)
    pv = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    o = o * corr[..., None] + pv
    return new_m, l, o


def finish(l: torch.Tensor, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``o / max(l, 1e-30)`` laid out ``[B, Sq, H, hd]`` in ``dtype``."""
    B, KV, g, Sq, hd = o.shape
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * g, hd).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group,
                   n_shards: int, scale: float, softcap: float = 0.0,
                   sliding_window: int = 0, is_local: bool = False) -> torch.Tensor:
    """Exact causal attention over a ring of sequence blocks. On this rank
    of ``group`` (``n_shards`` ranks): ``q [B, Sq, H, hd]``, ``k``/``v [B,
    Sk, KV, hd]``, the blocks at positions ``[r·Sq, (r+1)·Sq)``. Returns
    this rank's output block ``[B, Sq, H, hd]`` in ``q``'s dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if coll.group_size(group) != n_shards:
        raise ValueError(f"ring of {n_shards} shards over a group of {coll.group_size(group)}")
    r = dist.get_rank(group) if group is not None else 0
    dev = q.device
    qg = scaled_queries(q, KV, scale)
    q_pos = r * Sq + torch.arange(Sq, device=dev)
    m, l, o = init_state(B, Sq, KV, H // KV, hd, dev)
    for step in range(n_shards):
        # the hop of the block just held starts before its fold
        pending = coll.ring_shift_start((k, v), group) if step < n_shards - 1 else None
        owner = (r - step) % n_shards                     # whose block is held now
        k_pos = owner * Sk + torch.arange(Sk, device=dev)
        m, l, o = fold_block(m, l, o, qg, q_pos, k, v, k_pos, softcap=softcap,
                             sliding_window=sliding_window, is_local=is_local)
        if pending is not None:
            k, v = coll.ring_shift_wait(pending)
    return finish(l, o, q.dtype)

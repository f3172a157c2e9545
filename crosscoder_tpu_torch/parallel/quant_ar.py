"""Block-scaled int8 gradient all-reduce with error feedback
(``cfg.quant_grads``), ported from :mod:`crosscoder_tpu.parallel.quant_ar`.

Under pure data parallelism the step's collective is the gradient mean.
This exchange runs its two wire phases in int8 with f32 scales a
``block`` (EQuARX, PAPERS.md), about half a bf16 exchange's bytes:

- phase 1 (reduce-scatter shaped): each rank adds its residual to its
  padded flat gradient, cuts it into ``n_dev`` segments, quantizes them,
  and an all-to-all delivers segment ``j`` of every rank to rank ``j``,
  which dequantizes and sums in f32;
- phase 2 (all-gather shaped): each rank quantizes its reduced segment and
  an all-gather replicates every segment; dequantized and divided by
  ``n_dev``, that is the mean everywhere.

Error feedback: each rank keeps a residual the size of its padded vector
(``aux["quant_ef"]``, ``[n_data, L]`` a leaf, this rank's row held
locally): phase 1's local quantization error, plus phase 2's error of the
segment this rank owns at that segment's slot, ride the next step's
gradient, so the compressed mean converges to the exact one.

The quantize is :data:`quantize`, ``ops.quant.quantize_rows``: K11 on CUDA
tensors (the segments are rows whose width is a multiple of ``block``, and
blocks are independent, so the bytes are those of any row cut), the plain
``quantize_blocks`` on CPU tensors. Both take the compiled form of the
scale (ROADMAP C3), so phase 1's ``q`` and scales are the JAX exchange's
bytes. On one card (``n_dev`` 1) the exchange quantizes and feeds back as
on many; only the wire saving needs more ranks.
"""

from __future__ import annotations

import torch

from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.parallel import collectives as coll

quantize = quant.quantize_rows          # K11 on the card; swapped in chip checks


def padded_len(size: int, n_dev: int, block: int) -> int:
    """Flat length rounded up to ``n_dev`` segments of whole blocks (zero
    padding quantizes exactly)."""
    unit = n_dev * block
    return -(-size // unit) * unit


def ef_init(params: dict[str, torch.Tensor], n_dev: int, block: int,
            rows: int | None = None) -> dict[str, torch.Tensor]:
    """Zero residuals: ``[rows, L]`` f32 a param (``rows`` defaults to
    ``n_dev``, the full ``[n_data, L]`` array; a rank holds 1 row)."""
    rows = n_dev if rows is None else rows
    return {k: torch.zeros((rows, padded_len(v.numel(), n_dev, block)), dtype=torch.float32,
                           device=v.device)
            for k, v in params.items()}


def _quantized_pmean_leaf(g: torch.Tensor, ef: torch.Tensor, group, n_dev: int, me: int,
                          block: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """One leaf through the exchange: ``(mean gradient in g's shape and
    dtype, new residual [1, L], phase 1's (q, scales))``. ``ef`` is this
    rank's residual ``[1, L]``; ``me`` its index in ``group``."""
    L = ef.shape[-1]
    gf = g.reshape(-1).float()
    v = torch.zeros((L,), dtype=torch.float32, device=g.device)
    v[: gf.numel()] = gf
    v = v + ef.reshape(L)
    seg = v.reshape(n_dev, L // n_dev)
    # phase 1: quantize the local segments, segment j to rank j
    q, s = quantize(seg, block)
    new_ef = seg - quant.dequantize_blocks(q, s, torch.float32)
    qj = coll.all_to_all(q, group)
    sj = coll.all_to_all(s, group)
    partial = quant.dequantize_blocks(qj, sj, torch.float32).sum(dim=0)
    # phase 2: re-quantize the reduced segment, replicate every segment
    q2, s2 = quantize(partial[None], block)
    e2 = partial - quant.dequantize_blocks(q2, s2, torch.float32)[0]
    # the reduced segment's error is known only to its owner: credit it
    # to this rank's residual at the segment's slot
    new_ef[me] += e2
    qg = coll.all_gather(q2[0], group)                    # [n_dev, seg]
    sg = coll.all_gather(s2[0], group)
    out = quant.dequantize_blocks(qg, sg, torch.float32).reshape(L)[: gf.numel()]
    out = (out / n_dev).reshape(g.shape).to(g.dtype)
    return out, new_ef.reshape(ef.shape), {"q": q, "scales": s}


def quantized_pmean(group, g: torch.Tensor, ef: torch.Tensor, block: int
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """The exchange of one leaf over ``group`` for callers outside the
    trainer (tests, ``chip_smoke.py``): this rank's local gradient ``g``
    and residual ``ef [1, L]`` in; ``(mean, new residual, phase 1's
    {"q", "scales"})`` out. The JAX ``quantized_pmean_fn`` with the ranks
    in place of the stacked devices."""
    n_dev = coll.group_size(group)
    me = 0 if group is None else torch.distributed.get_rank(group)
    return _quantized_pmean_leaf(g, ef, group, n_dev, me, block)


def quantized_pmean_tree(grads: dict[str, torch.Tensor], ef: dict[str, torch.Tensor], group,
                         block: int) -> tuple[dict, dict]:
    """The exchange over a gradient dict, leaves in sorted order (every
    rank issues the same collectives in the same order)."""
    n_dev = coll.group_size(group)
    me = 0 if group is None else torch.distributed.get_rank(group)
    out, new_ef = {}, {}
    for k in sorted(grads):
        out[k], new_ef[k], _ = _quantized_pmean_leaf(grads[k], ef[k], group, n_dev, me, block)
    return out, new_ef

"""CE-recovered splicing eval, ported from
:mod:`crosscoder_tpu.analysis.ce_eval` (the reference notebook's
``get_ce_recovered_metrics``).

Per model m:

- ``ce_clean``: CE of the untouched forward;
- ``ce_zero_abl``: CE with the hook activation zeroed;
- ``ce_spliced``: CE with the post-BOS hook activations replaced by the
  reconstruction of both models' rows (BOS kept clean);
- ``ce_recovered = 1 − (spliced − clean) / (zero_abl − clean)``.

The crosscoder must be folded first
(:func:`crosscoder_tpu_torch.models.crosscoder.fold_scaling_factors`) so
that it takes raw activations. Each chunk's CEs, every model's clean,
zero-ablated and spliced, come from :func:`chunk_ces` as one ``[n_models,
3]`` f32 tensor on the device, and the host reads it back one chunk
behind (:func:`crosscoder_tpu_torch.utils.pipeline.drive`), so the card
runs the next chunk while the host reads. On the card a TopK
crosscoder's reconstruction runs the TopK mask kernel of its route on
the f32 rows (K6 at a 2^14-latent dictionary).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.utils import pipeline
from crosscoder_tpu_torch.utils.logging import source_tag


class Reconstructor(NamedTuple):
    """A reconstruction map ``apply(params, rows) -> rows`` and its params
    (``None`` for parameter-free oracles such as identity and zero)."""

    params: object
    apply: Callable[[object, torch.Tensor], torch.Tensor]


def crosscoder_reconstruct_fn(params: cc.Params, cfg: CrossCoderConfig) -> Reconstructor:
    """rows ``[N, n_sources, d_in]`` → reconstructed rows through the
    (folded) crosscoder: ``decode(encode(rows))``."""
    return Reconstructor(params, lambda p, rows: cc.forward(p, rows, cfg))


def _as_reconstructor(reconstruct) -> Reconstructor:
    if isinstance(reconstruct, Reconstructor):
        return reconstruct
    return Reconstructor(None, lambda _, rows: reconstruct(rows))


@torch.no_grad()
def chunk_ces(model_params: Sequence[lm.LMParams], reconstruct, tokens: torch.Tensor,
              lm_cfg: lm.LMConfig, hook_point: str) -> torch.Tensor:
    """All CEs of one token chunk ``[B, S]``: ``[n_models, 3]`` f32 on the
    device, columns (clean, zero_abl, spliced), with no host read."""
    rec = _as_reconstructor(reconstruct)
    n_models = len(model_params)
    clean, caches = [], []
    # one forward per model gives both the clean CE and the hook capture
    for p in model_params:
        logits, cache = lm.forward(p, tokens, lm_cfg, capture=[hook_point])
        clean.append(lm.loss_fn(logits, tokens))
        caches.append(cache[hook_point])
        del logits
    acts = torch.stack(caches, dim=2)[:, 1:]                  # [B, S-1, n, d]
    B, Sm1 = acts.shape[0], acts.shape[1]
    rows = acts.reshape(-1, n_models, lm_cfg.d_model).float()
    recon = rec.apply(rec.params, rows).reshape(B, Sm1, n_models, lm_cfg.d_model)
    per_model = []
    for m, p in enumerate(model_params):
        # splice_edit keeps BOS clean; pad the reconstruction back to S
        spliced_act = torch.cat([torch.zeros_like(recon[:, :1, m]), recon[:, :, m]], dim=1)
        zero = lm.ce_loss(p, tokens, lm_cfg, edits=[lm.Edit(hook_point, lm.zero_edit)])
        spliced = lm.ce_loss(p, tokens, lm_cfg,
                             edits=[lm.Edit(hook_point, lm.splice_edit, spliced_act)])
        per_model.append(torch.stack([clean[m], zero, spliced]))
    return torch.stack(per_model)


def get_ce_recovered_metrics(tokens: np.ndarray, lm_cfg: lm.LMConfig,
                             model_params: Sequence[lm.LMParams], hook_point: str,
                             reconstruct, chunk: int = 4) -> dict[str, float]:
    """CE clean / zero-ablated / spliced / recovered per model, each the
    mean over sequences (a ragged last chunk weighted by its size).

    ``reconstruct``: a :class:`Reconstructor` (see
    :func:`crosscoder_reconstruct_fn`) or a bare callable mapping the
    flattened post-BOS rows ``[N, n_models, d_in]`` (f32) to their
    reconstructions; identity gives ``ce_recovered`` 1 exactly. The models
    run on the device their params lie on."""
    rec = _as_reconstructor(reconstruct)
    n_models = len(model_params)
    tokens = np.asarray(tokens)
    if tokens.shape[0] < 1:
        raise ValueError("need at least one token sequence")
    dev = model_params[0]["embed"].device
    sums = np.zeros((n_models, 3), np.float64)
    total_seqs = 0

    def produced():
        for start in range(0, tokens.shape[0], chunk):
            tok = torch.as_tensor(tokens[start:start + chunk], device=dev).long()
            yield tok.shape[0], chunk_ces(model_params, rec, tok, lm_cfg, hook_point)

    def drain(item) -> None:
        nonlocal total_seqs
        b, ces = item
        sums[:] += b * ces.cpu().numpy().astype(np.float64)
        total_seqs += b

    pipeline.drive(produced(), drain, depth=2)     # read each chunk one chunk behind

    out: dict[str, float] = {}
    for m in range(n_models):
        tag = source_tag(m)
        clean, zero, spliced = (sums[m] / total_seqs).tolist()
        out[f"ce_clean_{tag}"] = clean
        out[f"ce_zero_abl_{tag}"] = zero
        out[f"ce_spliced_{tag}"] = spliced
        out[f"ce_diff_{tag}"] = spliced - clean
        out[f"ce_recovered_{tag}"] = 1.0 - (spliced - clean) / (zero - clean)
    return out

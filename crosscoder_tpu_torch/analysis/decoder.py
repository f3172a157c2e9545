"""Decoder-space model-diff statistics, ported from
:mod:`crosscoder_tpu.analysis.decoder` (the reference's ``analysis.py``).

The headline result is read off the decoder geometry alone: the relative
decoder norm ``‖dec_j‖ / (‖dec_i‖ + ‖dec_j‖)`` per latent separates
i-only (≈0), shared (≈0.5) and j-only (≈1) latents; shared latents are
the band ``0.3 < r < 0.7``; on them, the cosine of the paired decoder
rows is near 1. These return f32 tensors on the params' device;
:func:`firing_rates` returns host numpy, as its counts are accumulated
there.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np
import torch

from crosscoder_tpu_torch.models import crosscoder as cc

Params = Mapping[str, torch.Tensor]


def decoder_norms(params: Params) -> torch.Tensor:
    """Per-(latent, source) decoder row norms ``[d_hidden, n_sources]``,
    fp32."""
    return torch.linalg.norm(params["W_dec"].float(), dim=-1)


def relative_norms(params: Params, pair: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """``‖dec_j‖ / (‖dec_i‖ + ‖dec_j‖)`` per latent, in [0, 1]: ≈0 the
    latent belongs to source i only, ≈0.5 shared, ≈1 source j only."""
    norms = decoder_norms(params)
    i, j = pair
    return norms[:, j] / (norms[:, i] + norms[:, j] + 1e-12)


def shared_latent_mask(params: Params, pair: tuple[int, int] = (0, 1),
                       low: float = 0.3, high: float = 0.7) -> torch.Tensor:
    """Boolean ``[d_hidden]`` mask of the latents in the band
    ``low < r < high``."""
    r = relative_norms(params, pair)
    return (r > low) & (r < high)


def cosine_sims(params: Params, pair: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Cosine similarity of each latent's paired decoder rows
    ``[d_hidden]``."""
    w = params["W_dec"].float()
    i, j = pair
    a, b = w[:, i], w[:, j]
    na = torch.linalg.norm(a, dim=-1)
    nb = torch.linalg.norm(b, dim=-1)
    return torch.sum(a * b, dim=-1) / (na * nb + 1e-12)


def relative_norm_histogram(params: Params, pair: tuple[int, int] = (0, 1),
                            bins: int = 200) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts, edges)`` of the relative norms over [0, 1], as
    ``jnp.histogram`` bins them: f32 edges, each bin closed on the left,
    the last also on the right, values outside dropped."""
    r = relative_norms(params, pair)
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=torch.float32, device=r.device)
    idx = torch.searchsorted(edges, r, right=True)
    idx = torch.where(r == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts.to(torch.int32), edges


@torch.no_grad()
def firing_rates(params: Params, cfg, batches: Iterable) -> np.ndarray:
    """Per-latent firing rate over activation batches: the fraction of rows
    on which each latent is strictly positive (float64 ``[dict_size]``).
    Each batch ``[B, n_sources, d_in]`` (numpy or tensor, normalized as
    training rows were) is encoded on the params' device and reduced there
    to one count vector; the host sums the counts in int64."""
    dev = params["W_enc"].device
    count = np.zeros((cfg.dict_size,), np.int64)
    n = 0
    for b in batches:
        x = torch.as_tensor(b, device=dev)
        count += (cc.encode(params, x, cfg) > 0).sum(0).cpu().numpy()
        n += x.shape[0]
    if n == 0:
        raise ValueError("firing_rates needs at least one batch")
    return count.astype(np.float64) / n


def dead_latent_fraction(rates) -> float:
    """Fraction of latents that never fired."""
    return float((np.asarray(rates) == 0).mean())

"""Decoder-space model-diff statistics, ported from
:mod:`crosscoder_tpu.analysis.decoder` as far as serving reads them."""

from __future__ import annotations

from typing import Mapping

import torch


def decoder_norms(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-(latent, source) decoder row norms ``[d_hidden, n_sources]``,
    fp32."""
    return torch.linalg.norm(params["W_dec"].float(), dim=-1)


def relative_norms(params: Mapping[str, torch.Tensor],
                   pair: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """``‖dec_j‖ / (‖dec_i‖ + ‖dec_j‖)`` per latent, in [0, 1]: ≈0 the
    latent belongs to source i only, ≈0.5 shared, ≈1 source j only."""
    norms = decoder_norms(params)
    i, j = pair
    return norms[:, j] / (norms[:, i] + norms[:, j] + 1e-12)

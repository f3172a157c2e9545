"""The crosscoder, ported from :mod:`crosscoder_tpu.models.crosscoder` as
far as serving reads it.

Params keep the JAX package's leaf names and layout: ``W_enc [n, d_in,
d_hidden]``, ``W_dec [d_hidden, n, d_in]``, ``b_enc [d_hidden]``, ``b_dec
[n, d_in]``, where ``n`` is the source axis (models × hooked layers).
:func:`init_params` returns them as a dict of tensors; :class:`CrossCoder`
holds them as an ``nn.Module``.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.dtypes import dtype_of

Params = dict[str, torch.Tensor]


def init_params(cfg: CrossCoderConfig, *, seed: int = 0, device=None) -> Params:
    """Decoder rows standard-normal, rescaled to norm ``dec_init_norm`` per
    (latent, source); the encoder is the decoder's transpose; biases 0.
    Params are in ``cfg.enc_dtype``. Runs on ``cuda`` unless ``device``
    names another device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d_in, d_hidden = cfg.n_sources, cfg.d_in, cfg.dict_size
    dtype = dtype_of(cfg.enc_dtype)
    w = torch.randn((d_hidden, n, d_in), generator=gen, device=dev)
    w = w / torch.linalg.norm(w, dim=-1, keepdim=True) * cfg.dec_init_norm
    return {
        "W_dec": w.to(dtype),
        "W_enc": w.permute(1, 2, 0).to(dtype).contiguous(),
        "b_enc": torch.zeros((d_hidden,), dtype=dtype, device=dev),
        "b_dec": torch.zeros((n, d_in), dtype=dtype, device=dev),
    }


def pre_acts(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Encoder pre-activations ``x @ W_enc + b_enc`` summed over sources:
    ``[..., n, d_in]`` → ``[..., d_hidden]``, fp32 accumulation, result in
    ``x``'s dtype."""
    h = torch.einsum("...nd,ndh->...h", x.float(), params["W_enc"].float())
    return (h + params["b_enc"].float()).to(x.dtype)


class CrossCoder(nn.Module):
    """The crosscoder's serving params as an ``nn.Module`` (no gradients:
    training is not ported yet)."""

    def __init__(self, params: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        for name in ("W_enc", "W_dec", "b_enc", "b_dec"):
            self.register_parameter(name, nn.Parameter(params[name], requires_grad=False))

    def params(self) -> Params:
        return {name: p.data for name, p in self.named_parameters()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pre_acts(self.params(), x)

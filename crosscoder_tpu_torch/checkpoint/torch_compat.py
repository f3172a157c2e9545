"""The reference's ``.pt`` checkpoint layout, ported from
:mod:`crosscoder_tpu.checkpoint.torch_compat`.

The reference state_dict (reference ``crosscoder.py:33-62``) has the
tensor names and axis orders the port uses natively:

    W_enc [n_models, d_in, d_hidden]
    W_dec [d_hidden, n_models, d_in]
    b_enc [d_hidden]
    b_dec [n_models, d_in]

so conversion is a dtype and device change, not a transpose: the
state_dict holds CPU tensors in ``cfg.enc_dtype``, the port's params go
where the caller names. ``load_from_hf`` (the published checkpoint on the
hub) is not ported: it needs ``huggingface_hub`` and the network.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.dtypes import dtype_of

_PARAM_NAMES = ("W_enc", "W_dec", "b_enc", "b_dec")


def params_from_torch_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: CrossCoderConfig,
                                 device=None) -> dict[str, torch.Tensor]:
    """A reference state_dict → the port's params in ``cfg.enc_dtype`` on
    ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    return {n: torch.as_tensor(state_dict[n]).detach().float().to(dev, dtype_of(cfg.enc_dtype))
            for n in _PARAM_NAMES}


def params_to_torch_state_dict(params: Mapping[str, torch.Tensor], cfg: CrossCoderConfig
                               ) -> dict[str, torch.Tensor]:
    """The port's params → a reference state_dict: CPU tensors in
    ``cfg.enc_dtype``, rounded through f32 as the JAX package does."""
    return {n: params[n].detach().float().cpu().to(dtype_of(cfg.enc_dtype)) for n in _PARAM_NAMES}


def save_torch_checkpoint(params: Mapping[str, torch.Tensor], cfg: CrossCoderConfig,
                          path: str | Path) -> None:
    torch.save(params_to_torch_state_dict(params, cfg), path)


def load_torch_checkpoint(path: str | Path, cfg: CrossCoderConfig, device=None
                          ) -> dict[str, torch.Tensor]:
    return params_from_torch_state_dict(torch.load(path, map_location="cpu"), cfg, device)

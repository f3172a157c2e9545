"""Device half of the serving path: one encode→TopK→diff step, ported
from :mod:`crosscoder_tpu.serve.step`.

Gathers each request's last valid-token activation from the captured hook
plane, normalizes it per source, encodes it through the fused
encoder→TopK (:func:`crosscoder_tpu_torch.ops.fused_encoder_topk.fused_topk_encode`:
the Hopper kernel on the card, its plain version on the CPU; no
``[B, dict]`` pre-activation matrix on the card) and gathers each
selected latent's decoder-norm model-diff score. Results follow the fused
contract: ascending latent index, ``(0, 0)``-padded.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from crosscoder_tpu_torch.analysis import decoder
from crosscoder_tpu_torch.ops.fused_encoder_topk import fused_topk_encode
from crosscoder_tpu_torch.utils.dtypes import dtype_of


@torch.no_grad()
def encode_topk_diff(
    params: Mapping[str, torch.Tensor], captures: torch.Tensor, lengths: torch.Tensor,
    norm: torch.Tensor, *, enc_dtype: str, k: int, pair: tuple[int, int],
    encode: Callable = fused_topk_encode,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(vals [B,k], idx [B,k] int32, diff [B,k] f32)`` from captured hooks.

    - ``captures [B, S, n_sources, d_in]``: the capture output (only
      position ``lengths-1`` of each row is read);
    - ``lengths [B]``: valid token count per request;
    - ``norm [n_sources] f32``: per-source calibration factors.

    ``encode`` takes ``fused_topk_encode``'s signature; passing its plain
    version re-runs the step without the kernel. Every output row depends
    only on its own request's row.
    """
    B = captures.shape[0]
    last = lengths.to(device=captures.device, dtype=torch.int64) - 1
    x = captures[torch.arange(B, device=captures.device), last]     # [B, n_src, d_in]
    x = (x.float() * norm.to(captures.device)[:, None]).to(dtype_of(enc_dtype))
    W_enc = params["W_enc"]
    vals, idx = encode(x.reshape(B, -1), W_enc.reshape(-1, W_enc.shape[-1]),
                       params["b_enc"], k)
    r = decoder.relative_norms(params, pair)                        # [d_hidden]
    return vals, idx, r[idx.long()]


def diff_pair(n_sources: int, n_models: int) -> tuple[int, int]:
    """The source pair the diff score compares: model 0 vs model 1 at the
    first hooked layer under the model-major source order; ``(0, 0)`` for
    a single source (diff is then 0.5)."""
    n_hooks = max(1, n_sources // max(1, n_models))
    j = n_hooks if n_sources > n_hooks else 0
    return (0, j)

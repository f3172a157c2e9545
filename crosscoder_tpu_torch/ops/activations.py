"""Encoder nonlinearities, ported from :mod:`crosscoder_tpu.ops.activations`
for ``relu`` and ``topk``.

- :func:`relu`: ``torch.relu`` (its subgradient at 0 is 0, as the JAX
  package's ``jax.nn.relu``).
- :func:`topk`: the k largest ReLU'd entries per row, zeros elsewhere,
  ties to the lowest index, straight-through gradient on the survivors.
  It dispatches to :func:`crosscoder_tpu_torch.ops.topk_pallas.topk`: the
  K5 kernel on CUDA tensors (bf16 rows up to 2^16 wide, else
  :class:`ValueError`), the plain version on CPU tensors.
- :func:`_topk_dense`: the dense reference (relu, exact top-k, scatter),
  differentiable through autograd; the mask it keeps is the kernel's.

``batchtopk`` and ``jumprelu`` need the BatchTopK kernels (K9, and K4 on
the fused tier); :func:`apply` raises :class:`NotImplementedError` for
them until the slice that ports those kernels.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from crosscoder_tpu_torch.ops import topk_pallas

if TYPE_CHECKING:
    from crosscoder_tpu_torch.config import CrossCoderConfig


def relu(h: torch.Tensor) -> torch.Tensor:
    return torch.relu(h)


def topk(h: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest ReLU'd entries per row (ties to the lowest
    index), zero elsewhere."""
    return topk_pallas.topk(h, k)


def _topk_dense(h: torch.Tensor, k: int) -> torch.Tensor:
    """Dense reference of :func:`topk`: relu, then keep the exact top-k
    (the same selection as the kernel); gradients through autograd."""
    keep = topk_pallas.topk_plain(h.detach(), k) != 0
    hp = relu(h)
    return torch.where(keep, hp, torch.zeros((), dtype=hp.dtype, device=hp.device))


def apply(h: torch.Tensor, cfg: "CrossCoderConfig", params: dict | None = None) -> torch.Tensor:
    """Dispatch on ``cfg.activation``."""
    if cfg.activation == "relu":
        return relu(h)
    if cfg.activation == "topk":
        return topk(h, cfg.topk_k)
    if cfg.activation in ("batchtopk", "jumprelu"):
        raise NotImplementedError(
            f"activation={cfg.activation!r} is not ported yet: it comes with the "
            f"BatchTopK/JumpReLU slice, which ports kernels K9 and K4 "
            f"(ROADMAP Queue A 2, Queue B)")
    raise ValueError(f"unknown activation {cfg.activation!r}")

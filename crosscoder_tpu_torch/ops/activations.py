"""Encoder nonlinearities, ported from :mod:`crosscoder_tpu.ops.activations`:
``relu``, ``topk``, ``batchtopk`` and ``jumprelu``.

- :func:`relu`: ``torch.relu`` (its subgradient at 0 is 0, as the JAX
  package's ``jax.nn.relu``).
- :func:`topk`: the k largest ReLU'd entries per row, zeros elsewhere,
  ties to the lowest index, straight-through gradient on the survivors.
  It dispatches to :func:`crosscoder_tpu_torch.ops.topk_pallas.topk`, as
  the JAX package's kernel dispatch: K5 for bf16 rows up to 2^16 wide, K6
  for f32 rows that fit its single-block gate, K7 for every wider row
  (f32 or bf16, any width) on CUDA tensors; their plain versions on CPU
  tensors.
- :func:`_topk_dense`: the dense reference (relu, exact top-k, scatter),
  differentiable through autograd; the mask it keeps is the kernel's.
- :func:`batchtopk`: every ReLU'd entry at or above the ``k·batch``-th
  largest of the whole batch (all ties kept); :func:`batchtopk_fixed`, its
  eval mode, against a calibrated threshold. Both dispatch to the K9
  kernels (``topk_pallas.batchtopk``/``batchtopk_fixed``) on CUDA tensors,
  their plain versions on CPU tensors.
- :func:`batchtopk_threshold_of`: the threshold's value, by the JAX
  package's exact bit-pattern bisection (:func:`_kth_largest_nonneg`),
  shared with eval calibration.

- :func:`jumprelu`: ``h · 1[h > θ]`` with ``θ = exp(log_theta)`` per
  latent, and :func:`jumprelu_l0`, the L0 objective ``mean_b Σ_f 1[h >
  θ_f]``; both differentiable in ``log_theta`` through the rectangle-kernel
  straight-through estimator of width ``bandwidth`` (the JAX package's
  ``custom_vjp`` pair: the difference ``h − θ`` in f32, the rectangle
  inclusive, the comparison strict). Plain PyTorch: the JAX package fuses
  them in XLA, with no Pallas kernel.
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


def batchtopk(h: torch.Tensor, k: int) -> torch.Tensor:
    """TopK over the flattened (batch × d_hidden) pre-acts: keep the
    ``k · batch`` largest ReLU'd entries globally (ties at the threshold
    all kept)."""
    return topk_pallas.batchtopk(h, k)


def batchtopk_fixed(h: torch.Tensor, threshold: float) -> torch.Tensor:
    """BatchTopK eval mode: a fixed global threshold, so one example's
    activations never depend on the rest of its batch."""
    return topk_pallas.batchtopk_fixed(h, threshold)


def batchtopk_threshold_of(hp: torch.Tensor, k: int) -> torch.Tensor:
    """The ``(k·batch)``-th largest of the ReLU'd pre-acts ``hp``, a 0-d
    tensor in ``hp``'s dtype: the BatchTopK threshold, shared by training
    and eval calibration."""
    return _kth_largest_nonneg(hp, topk_pallas.batchtopk_budget(hp, k))


def _kth_largest_nonneg(hp: torch.Tensor, kk: int) -> torch.Tensor:
    """Exact ``kk``-th largest value of a non-negative tensor: integer
    bisection on the f32 bit patterns (order-isomorphic for non-negative
    floats), as the JAX package's, in ``hp``'s dtype."""
    hpf = hp.detach().float()
    bits = hpf.reshape(-1).view(torch.int32).to(torch.int64)
    hi = max(int(hpf.max().reshape(1).view(torch.int32)), 0) + 1
    lo = topk_pallas.kth_largest_pattern(bits, kk, hi)
    return torch.tensor([lo], dtype=torch.int32).view(torch.float32).to(hp.dtype).reshape(())


class _JumpReLU(torch.autograd.Function):
    """``h · 1[h > θ]``; backward ``dh = g·1[h > θ]`` in ``h``'s dtype and
    ``dlog_theta = Σ_batch −(θ/ε)·1[|h − θ| ≤ ε/2]·g·θ`` in f32."""

    @staticmethod
    def forward(ctx, h, log_theta, bandwidth):
        theta = torch.exp(log_theta).to(h.dtype)
        ctx.save_for_backward(h, theta)
        ctx.bandwidth = bandwidth
        return h * (h > theta)

    @staticmethod
    def backward(ctx, g):
        h, theta = ctx.saved_tensors
        hf, tf, gf = h.float(), theta.float(), g.float()
        dh = gf * (hf > tf)
        rect = ((hf - tf).abs() <= ctx.bandwidth / 2).float()
        units = -(tf / ctx.bandwidth) * rect * gf
        dlog_theta = (units * tf).sum(dim=tuple(range(units.ndim - 1)))
        return dh.to(h.dtype), dlog_theta, None


class _JumpReLUL0(torch.autograd.Function):
    """``mean_b Σ_f 1[h > θ_f]`` (f32 scalar); backward: no gradient for
    ``h``, ``dlog_theta = g·(−1/ε)·mean_b 1[|h − θ| ≤ ε/2]·θ``."""

    @staticmethod
    def forward(ctx, h, log_theta, bandwidth):
        theta = torch.exp(log_theta).to(h.dtype)
        ctx.save_for_backward(h, theta)
        ctx.bandwidth = bandwidth
        return (h > theta).float().sum(dim=-1).mean()

    @staticmethod
    def backward(ctx, g):
        h, theta = ctx.saved_tensors
        hf, tf = h.float(), theta.float()
        rect = ((hf - tf).abs() <= ctx.bandwidth / 2).float()
        dtheta = -(1.0 / ctx.bandwidth) * rect.mean(dim=tuple(range(rect.ndim - 1)))
        return torch.zeros_like(h), (g * dtheta * tf).float(), None


def jumprelu(h: torch.Tensor, log_theta: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """JumpReLU with per-latent threshold ``exp(log_theta)`` (f32
    ``log_theta [d_hidden]``), straight-through in ``log_theta``."""
    return _JumpReLU.apply(h, log_theta, bandwidth)


def jumprelu_l0(h: torch.Tensor, log_theta: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """The JumpReLU paper's L0 objective, differentiable in ``log_theta``."""
    return _JumpReLUL0.apply(h, log_theta, bandwidth)


def apply(h: torch.Tensor, cfg: "CrossCoderConfig", params: dict | None = None) -> torch.Tensor:
    """Dispatch on ``cfg.activation``."""
    if cfg.activation == "relu":
        return relu(h)
    if cfg.activation == "topk":
        return topk(h, cfg.topk_k)
    if cfg.activation == "batchtopk":
        if cfg.batchtopk_threshold > 0:
            return batchtopk_fixed(h, cfg.batchtopk_threshold)
        return batchtopk(h, cfg.topk_k)
    if cfg.activation == "jumprelu":
        if params is None or "log_theta" not in params:
            raise ValueError("jumprelu requires params['log_theta']")
        return jumprelu(h, params["log_theta"], cfg.jumprelu_bandwidth)
    raise ValueError(f"unknown activation {cfg.activation!r}")

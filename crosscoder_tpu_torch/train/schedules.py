"""LR and L1-coefficient schedules, ported from
:mod:`crosscoder_tpu.train.schedules`.

- LR (reference ``trainer.py:28-32``): constant, then linear decay to 0
  over the final ``lr_decay_frac`` of training.
- Sparsity warmup: a 0→1 ramp over the first ``l1_warmup_frac`` of
  training; the L1 coefficient is ``cfg.l1_coeff`` times it (reference
  ``trainer.py:34-39``).

All are evaluated at the pre-increment step (λ(0) = 1 on the first
optimizer step, l1_coeff(0) = 0). The step functions compute in float32,
as the JAX package's jitted schedules do, so both packages feed the same
f32 numbers into the step; :func:`lr_lambda` and :func:`l1_coeff_at` are
the reference's float64 host forms.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from crosscoder_tpu_torch.config import CrossCoderConfig

Schedule = Callable[[int], np.float32]


def lr_schedule(cfg: CrossCoderConfig) -> Schedule:
    total = cfg.total_steps
    decay_start = (1.0 - cfg.lr_decay_frac) * total

    def f(step: int) -> np.float32:
        s = np.float32(step)
        if s < np.float32(decay_start):
            frac = np.float32(1.0)
        else:
            frac = np.maximum(np.float32(0.0), np.float32(1.0) - (s - np.float32(decay_start))
                              / np.float32(total - decay_start))
        return np.float32(cfg.lr) * frac

    return f


def sparsity_warmup_schedule(cfg: CrossCoderConfig) -> Schedule:
    """The bare 0→1 ramp of the L1 warmup (``l1_warmup_frac`` window)."""
    warmup = cfg.l1_warmup_frac * cfg.total_steps

    def f(step: int) -> np.float32:
        if warmup <= 0:
            return np.float32(1.0)
        return np.minimum(np.float32(1.0), np.float32(step) / np.float32(warmup))

    return f


def l1_coeff_schedule(cfg: CrossCoderConfig) -> Schedule:
    ramp = sparsity_warmup_schedule(cfg)

    def f(step: int) -> np.float32:
        return np.float32(cfg.l1_coeff) * ramp(step)

    return f


def lr_lambda(step: int, cfg: CrossCoderConfig) -> float:
    """Multiplier form of :func:`lr_schedule` (what reference
    ``trainer.py:28-32`` feeds into ``LambdaLR``)."""
    total = cfg.total_steps
    decay_start = (1.0 - cfg.lr_decay_frac) * total
    if step < decay_start:
        return 1.0
    return max(0.0, 1.0 - (step - decay_start) / (total - decay_start))


def l1_coeff_at(step: int, cfg: CrossCoderConfig) -> float:
    """Scalar :func:`l1_coeff_schedule` (reference ``trainer.py:34-39``)."""
    warmup = cfg.l1_warmup_frac * cfg.total_steps
    if warmup <= 0:
        return cfg.l1_coeff
    return cfg.l1_coeff * min(1.0, step / warmup)

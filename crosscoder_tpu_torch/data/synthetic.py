"""Synthetic paired-activation source with a known sparse ground truth,
ported from :mod:`crosscoder_tpu.data.synthetic` and kept in numpy, so
that batch *i* is bitwise the JAX source's batch *i* for the same seed.

Rows are ``x = Σ_j mag[b, j] · D[idx[b, j]] + ε`` over a fixed random
dictionary ``D`` of ``n_true`` unit rows (per source), ``sparsity`` active
features per row. Batch *i* is a pure function of ``(seed, i)``, so a
resumed run sees the identical stream. Several consumers (the fleet's
tenants) share the stream through :meth:`SyntheticActivationSource.next_for`
(:mod:`crosscoder_tpu_torch.data.fanout`).
"""

from __future__ import annotations

import numpy as np

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.fanout import FanOut


class SyntheticActivationSource(FanOut):
    def __init__(self, cfg: CrossCoderConfig, n_true: int | None = None, sparsity: int = 8,
                 noise: float = 0.01) -> None:
        self.cfg = cfg
        self.n_true = n_true if n_true is not None else max(16, cfg.dict_size // 4)
        self.sparsity = sparsity
        self.noise = noise
        root = np.random.default_rng(cfg.seed)
        d = root.normal(size=(self.n_true, cfg.n_sources, cfg.d_in)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        self.dictionary = d
        self.counter = 0
        self._init_fanout()

    def next(self) -> np.ndarray:
        """The next ``[batch_size, n_sources, d_in]`` f32 batch."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.counter))
        self.counter += 1
        b = cfg.batch_size
        idx = rng.integers(0, self.n_true, size=(b, self.sparsity))
        mag = np.abs(rng.normal(1.0, 0.3, size=(b, self.sparsity))).astype(np.float32)
        x = self.noise * rng.standard_normal(size=(b, cfg.n_sources, cfg.d_in), dtype=np.float32)
        for j in range(self.sparsity):
            x += mag[:, j, None, None] * self.dictionary[idx[:, j]]
        return x

    def _stream_head(self) -> int:
        return self.counter

    def next_for(self, name: str) -> np.ndarray:
        """The batch at consumer ``name``'s cursor (:meth:`next` for the
        first consumer at the head, the same array for its peers)."""
        return self._serve_for(name, self.next)

    def state_dict(self) -> dict:
        return {"counter": self.counter, **self._consumer_state()}

    def load_state_dict(self, d: dict) -> None:
        self.counter = int(d["counter"])
        self._realign_consumers(d)

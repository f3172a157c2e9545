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
        self._term: np.ndarray | None = None     # one feature's term, reused by every serve
        self._init_fanout()

    @property
    def batch_shape(self) -> tuple[int, int, int]:
        return (self.cfg.batch_size, self.cfg.n_sources, self.cfg.d_in)

    def next(self, out: np.ndarray | None = None) -> np.ndarray:
        """The next ``[batch_size, n_sources, d_in]`` f32 batch: a new
        array, or ``out`` filled. Its terms are made in place in one
        scratch array kept across serves: at the training shape each would
        be a new 75 MB array, and a thread other than the main one maps
        such an array afresh."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, self.counter))
        self.counter += 1
        b = cfg.batch_size
        idx = rng.integers(0, self.n_true, size=(b, self.sparsity))
        mag = np.abs(rng.normal(1.0, 0.3, size=(b, self.sparsity))).astype(np.float32)
        x = rng.standard_normal(size=self.batch_shape, dtype=np.float32, out=out)
        x *= self.noise
        if self._term is None or self._term.shape != x.shape:
            self._term = np.empty_like(x)
        term = self._term
        for j in range(self.sparsity):
            np.take(self.dictionary, idx[:, j], axis=0, out=term, mode="clip")
            np.multiply(mag[:, j, None, None], term, out=term)
            x += term
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

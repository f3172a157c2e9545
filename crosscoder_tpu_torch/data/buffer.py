"""Paired-activation replay buffer, ported from
:mod:`crosscoder_tpu.data.buffer` (the synchronous path).

Harvest → calibrate → store → shuffle → serve, as the JAX package does it:

- **Harvest** on the device: every model's hook activations for a chunk of
  ``model_batch_size`` token sequences come from one padded capture
  forward (:func:`crosscoder_tpu_torch.models.lm.run_with_cache_multi`),
  ``[C, S, n_sources, d_in]`` in bf16; BOS rows are dropped before storing.
- **Sizes**: ``buffer_size = batch_size·buffer_mult`` rounded down to whole
  ``seq_len − 1``-row sequences; the first fill harvests the whole buffer,
  every later cycle ``refill_frac`` of it.
- **Norm calibration**: per source ``sqrt(d_in) / mean token norm`` over
  ``norm_calib_batches · model_batch_size`` sequences (BOS included),
  reduced on the device per chunk and summed in float64 on the host.
- **Serving** through a seeded index permutation
  (``np.random.default_rng(cfg.seed)``) instead of moving rows; the refill
  runs incrementally between serves, chunk writes landing only on rows
  the current fill can no longer serve, and the cycle completes (re-shuffle,
  pointer reset) once the read pointer passes ``buffer_size//2 − batch``.
- **Resume**: :meth:`PairedActivationBuffer.state_dict` records the token
  position of the oldest unserved row; a restore refills from there.

All index bookkeeping is numpy, as in the JAX package, so the served
stream is byte-identical to the JAX buffer's given the same harvested
chunks. Two store formats, chosen by :func:`make_buffer` from
``cfg.quant_buffer``, each held in host RAM or, under
``buffer_device="hbm"``, on the harvest device (the JAX package's
donated scatter and gather become ``index_copy_``/``index_select`` on
the store's tensors, :mod:`crosscoder_tpu_torch.data.hostops`):

- :class:`PairedActivationBuffer`: bf16 rows;
- :class:`QuantPairedActivationBuffer`: block-scaled int8 rows plus f32
  scales (:mod:`crosscoder_tpu_torch.ops.quant`). The harvest chunk is
  quantized on the harvest device through the K11 kernel, and only the
  int8 rows and scales move to a host store. Serving dequantizes to bf16.

A ragged last chunk is padded to the harvest shape by repeating a
sequence; only its real sequences are written, so the padding never
reaches a store. The JAX package's four class names stay:
``DevicePairedActivationBuffer`` and ``QuantDevicePairedActivationBuffer``
are the two classes above, whose store place follows
``cfg.buffer_device``.

Not ported here (``cfg.check_buffer`` raises): the paged harvest runtime,
the segmented harvest and refill-overlap dispatcher, mesh-sharded stores,
multi-consumer fan-out, sequence-parallel harvest.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import hostops
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.pipeline import DEFAULT_DEPTH, drive


def _chunk_norm_sums(acts: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Per-source sum of token norms over the first ``n_valid`` sequences
    of a chunk ``[C, S, n, d]``, f32 ``[n]``, on the chunk's device."""
    norms = torch.linalg.norm(acts.float(), dim=-1)                      # [C, S, n]
    mask = (torch.arange(acts.shape[0], device=acts.device) < n_valid)[:, None, None]
    return (norms * mask).sum(dim=(0, 1))


class PairedActivationBuffer:
    """Serves shuffled paired activations for crosscoder training, from a
    bf16 store in host RAM, or on ``device`` under ``buffer_device="hbm"``
    (batches are then served as device tensors, which the trainer does not
    copy again).

    ``model_params``: one LM param dict per model (``len == cfg.n_models``),
    on ``device``; ``tokens``: ``[n_seqs, seq_len]`` token ids. Runs on
    ``cuda`` unless ``device`` names another device. ``lazy=True`` defers
    calibration and the first fill to :meth:`load_state_dict`.
    """

    PIPELINE_DEPTH = DEFAULT_DEPTH

    def __init__(self, cfg: CrossCoderConfig, lm_cfg: lm.LMConfig,
                 model_params: Sequence[lm.LMParams], tokens, lazy: bool = False,
                 device=None) -> None:
        if len(model_params) != cfg.n_models:
            raise ValueError(f"got {len(model_params)} param sets for n_models={cfg.n_models}")
        cfg.check_buffer()
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        self.model_params = list(model_params)
        self.device = resolve_device(device)
        self.store_device = self.device if cfg.buffer_device == "hbm" else torch.device("cpu")
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 2 or self.tokens.shape[1] != cfg.seq_len:
            raise ValueError(f"tokens must be [n_seqs, {cfg.seq_len}], got {self.tokens.shape}")
        self.hook_points = cfg.resolved_hook_points()
        rows_per_seq = cfg.seq_len - 1                     # BOS dropped
        self.buffer_batches = cfg.batch_size * cfg.buffer_mult // rows_per_seq
        self.buffer_size = self.buffer_batches * rows_per_seq
        self._chunk_seqs = cfg.model_batch_size
        self._alloc_store()
        self._perm = np.arange(self.buffer_size)
        self._rng = np.random.default_rng(cfg.seed)
        self.pointer = 0              # read position in the permutation
        self.token_pointer = 0        # next unharvested sequence (mod corpus)
        self._global_seq = 0          # monotone count of harvested sequences
        # which global sequence produced each store row (resume provenance)
        self._src_global = np.zeros(self.buffer_size, dtype=np.int64)
        self.first = True
        self._filled = False
        self._cyc_seq_done = 0
        self._cyc_inflight: list[tuple] = []
        if not lazy:
            self.normalisation_factor = self._estimate_norm_scaling_factors()
            self.refresh()

    # ------------------------------------------------------------------
    # store

    def _alloc_store(self) -> None:
        self._store = torch.zeros((self.buffer_size, self.cfg.n_sources, self.cfg.d_in),
                                  dtype=torch.bfloat16, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return (self._store,)

    def store_nbytes(self) -> int:
        """Bytes the replay store occupies on :attr:`store_device`."""
        return sum(t.numel() * t.element_size() for t in self._store_tensors())

    def _write_rows(self, positions: np.ndarray, rows: torch.Tensor) -> None:
        """Store harvested bf16 rows ``[r, n_sources, d_in]`` (on the
        harvest device) at store rows ``positions``."""
        hostops.scatter_rows(self._store, positions, rows.to(self.store_device))

    def _read_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Store rows ``idx`` as bf16 on :attr:`store_device`."""
        return hostops.gather_rows(self._store, idx)

    def _refill_batches(self) -> int:
        """Sequences harvested per steady-state cycle."""
        return max(1, int(self.buffer_batches * self.cfg.refill_frac))

    # ------------------------------------------------------------------
    # harvest

    def _pad_chunk(self, token_batch: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad a ragged chunk to the fixed harvest shape by repeating its
        first sequence; returns ``(padded, n_real)``."""
        n = token_batch.shape[0]
        if n != self._chunk_seqs:
            assert n < self._chunk_seqs, (n, self._chunk_seqs)
            pad = np.broadcast_to(token_batch[:1], (self._chunk_seqs - n, *token_batch.shape[1:]))
            token_batch = np.concatenate([token_batch, pad])
        return token_batch, n

    def _harvest_dev(self, padded_tokens: np.ndarray) -> torch.Tensor:
        """All sources' hook activations for one fixed-shape chunk,
        ``[C, S, n_sources, d_in]`` bf16 on the device (source axis
        model-major). Asynchronous on the card."""
        tok = torch.as_tensor(np.asarray(padded_tokens, dtype=np.int64), device=self.device)
        acts = lm.run_with_cache_multi(self.model_params, tok, self.lm_cfg, self.hook_points)
        return acts.to(torch.bfloat16)

    def _estimate_norm_scaling_factors(self) -> np.ndarray:
        """Per-source ``sqrt(d_in) / mean_token_norm`` (BOS included): each
        chunk's norm sums reduce on the device to ``[n_sources]``, fetched
        with a lag of ``PIPELINE_DEPTH`` chunks and summed in float64."""
        cfg = self.cfg
        n_seqs = min(cfg.norm_calib_batches * cfg.model_batch_size, self.tokens.shape[0])
        sums = np.zeros((cfg.n_sources,), np.float64)
        count = 0

        def produced():
            nonlocal count
            for start in range(0, n_seqs, self._chunk_seqs):
                chunk = self.tokens[start: start + self._chunk_seqs][:n_seqs - start]
                padded, n = self._pad_chunk(chunk)
                count += n * chunk.shape[1]
                yield _chunk_norm_sums(self._harvest_dev(padded), n)

        def drain(part: torch.Tensor) -> None:
            nonlocal sums
            sums += part.cpu().numpy().astype(np.float64)

        drive(produced(), drain, depth=self.PIPELINE_DEPTH)
        mean_norm = sums / max(count, 1)
        return (np.sqrt(cfg.d_in) / mean_norm).astype(np.float32)

    def refresh(self) -> None:
        """Synchronous refill (first fill, resume, tests): the whole buffer
        the first time, ``refill_frac`` of it after."""
        num_batches = self.buffer_batches if self.first else self._refill_batches()
        self.first = False
        self._begin_cycle(num_batches)
        self._finish_cycle()

    # -- incremental refill cycle ---------------------------------------
    #
    # One cycle harvests `_cyc_batches` sequences into the rows the current
    # fill can no longer serve: already-served permutation slots, and the
    # statically unserved tail [m·batch, target) past the m serves that
    # reach the trigger. Writes go tail-first (rotation `_cyc_rot`), then
    # follow the read pointer; a chunk at write offset w of r rows may land
    # once w + r <= pointer + tail. Chunks are dispatched `_cyc_segs_per_serve`
    # a serve, at most PIPELINE_DEPTH in flight; only the drain waits on
    # the write-safety rule.

    def _begin_cycle(self, num_batches: int | None = None) -> None:
        rows_per_seq = self.cfg.seq_len - 1
        # a forced refresh mid-cycle abandons the cycle: nothing it
        # dispatched has been served, so rewind the token stream over it
        dropped = self._cyc_seq_done
        if dropped:
            self.token_pointer = (self.token_pointer - dropped) % self.tokens.shape[0]
            self._global_seq -= dropped
            self._cyc_inflight = []
        if num_batches is None:
            num_batches = self._refill_batches()
        b = self.cfg.batch_size
        trigger = self.buffer_size // 2 - b
        served_at_finish = (trigger // b + 1) * b
        self._cyc_batches = num_batches
        self._cyc_target = num_batches * rows_per_seq
        # a full fill is synchronous and keeps the linear write order
        if self._cyc_target > self.buffer_size // 2:
            self._cyc_tail = 0
        else:
            self._cyc_tail = max(0, self._cyc_target - served_at_finish)
        self._cyc_rot = served_at_finish if self._cyc_tail else 0
        self._cyc_seq_done = 0          # sequences dispatched so far
        self._cyc_write = 0             # rows dispatched so far
        self._cyc_drained = 0           # rows landed in the store
        self._cyc_inflight = []
        n_chunks = -(-num_batches // self._chunk_seqs)
        serves = max(1, trigger // b + 1)
        self._cyc_segs_per_serve = -(-n_chunks // serves)

    def _cyc_logical(self, woff: int, n_rows: int) -> np.ndarray:
        """Store rows for cycle write offsets ``[woff, woff + n_rows)``."""
        j = np.arange(woff, woff + n_rows)
        order = np.where(j < self._cyc_tail, self._cyc_rot + j, j - self._cyc_tail)
        return self._perm[order]

    def _record_src(self, woff: int, n_rows: int, seq_globals: np.ndarray) -> None:
        self._src_global[self._cyc_logical(woff, n_rows)] = np.repeat(
            seq_globals, self.cfg.seq_len - 1)

    def _step_job(self) -> bool:
        """Dispatch the next chunk's harvest, unless the cycle has nothing
        left to dispatch or PIPELINE_DEPTH chunks are in flight."""
        if (self._cyc_seq_done >= self._cyc_batches
                or len(self._cyc_inflight) + 1 > self.PIPELINE_DEPTH):
            return False
        n_seqs = min(self._chunk_seqs, self._cyc_batches - self._cyc_seq_done)
        seq_globals = self._global_seq + np.arange(n_seqs)
        padded, n = self._pad_chunk(self._take_tokens(n_seqs))
        self._cyc_inflight.append((self._harvest_dev(padded), n, seq_globals, self._cyc_write))
        self._cyc_seq_done += n_seqs
        self._cyc_write += n_seqs * (self.cfg.seq_len - 1)
        return True

    def _drain_one(self) -> None:
        cfg = self.cfg
        acts_dev, n, seq_globals, woff = self._cyc_inflight.pop(0)
        # the real sequences only, BOS dropped
        rows = acts_dev[:n, 1:].reshape(-1, cfg.n_sources, cfg.d_in)
        self._write_rows(self._cyc_logical(woff, rows.shape[0]), rows)
        self._record_src(woff, rows.shape[0], seq_globals)
        self._cyc_drained += rows.shape[0]

    def _head_drainable(self) -> bool:
        """The oldest in-flight chunk's rows are free once the read pointer
        (plus the unserved tail) covers its write extent."""
        if not self._cyc_inflight:
            return False
        _, n, _, woff = self._cyc_inflight[0]
        return woff + n * (self.cfg.seq_len - 1) <= self.pointer + self._cyc_tail

    def _advance_cycle(self) -> None:
        """One serve's worth of refill: dispatch the paced chunks and land
        every chunk whose rows the read pointer has freed."""
        credit = self._cyc_segs_per_serve
        while credit > 0 and self._step_job():
            credit -= 1
        while self._head_drainable():
            with trace.span("harvest"):
                self._drain_one()

    def _finish_cycle(self) -> None:
        """Dispatch and land what is left of the cycle, re-shuffle, reset
        the read pointer and open the next cycle."""
        with trace.span("refill", target_rows=self._cyc_target):
            while self._cyc_seq_done < self._cyc_batches:
                if not self._step_job():            # depth window full: free a slot
                    with trace.span("harvest"):
                        self._drain_one()
            while self._cyc_inflight:
                with trace.span("harvest"):
                    self._drain_one()
        assert self._cyc_drained == self._cyc_write == self._cyc_target
        self._cyc_seq_done = 0
        self._perm = self._rng.permutation(self.buffer_size)
        self.pointer = 0
        self._filled = True
        # suffix-min of provenance in serve order: state_dict in O(1)
        self._suffix_min_src = np.minimum.accumulate(self._src_global[self._perm][::-1])[::-1]
        self._begin_cycle()

    def _take_tokens(self, n: int) -> np.ndarray:
        """Next ``n`` sequences, wrapping at the end of the corpus."""
        total = self.tokens.shape[0]
        idx = (self.token_pointer + np.arange(n)) % total
        self.token_pointer = (self.token_pointer + n) % total
        self._global_seq += n
        return self.tokens[idx]

    # ------------------------------------------------------------------
    # serving

    def _next_idx(self) -> np.ndarray:
        if not self._filled:
            raise RuntimeError(
                "buffer was built lazy and never filled; call load_state_dict "
                "(resume) or refresh() first")
        idx = self._perm[self.pointer: self.pointer + self.cfg.batch_size]
        self.pointer += self.cfg.batch_size
        return idx

    def next(self) -> torch.Tensor:
        """One training batch ``[batch_size, n_sources, d_in]`` f32 with the
        norm factors applied, on :attr:`store_device`."""
        idx = self._next_idx()
        out = hostops.gather_scale_f32(self._store, idx, self.normalisation_factor)
        self._after_serve()
        return out

    def next_raw(self) -> torch.Tensor:
        """One training batch of raw bf16 rows on :attr:`store_device`; the
        trainer applies :attr:`normalisation_factor` in the step."""
        idx = self._next_idx()
        out = self._read_rows(idx)
        self._after_serve()
        return out

    def _after_serve(self) -> None:
        self._advance_cycle()
        if self.pointer > self.buffer_size // 2 - self.cfg.batch_size:
            self._finish_cycle()

    # ------------------------------------------------------------------
    # resume

    def state_dict(self) -> dict[str, Any]:
        """Stream-resume state (the JAX package's format): the token
        position of the oldest unserved row, the shuffle generator's state
        and the norm factors. A save before the first fill records a
        from-scratch state."""
        if not self._filled:
            return {"token_pointer": 0, "rng_state": self._rng.bit_generator.state,
                    "normalisation_factor": None}
        oldest = (int(self._suffix_min_src[self.pointer]) if self.pointer < self.buffer_size
                  else self._global_seq)
        return {
            "token_pointer": oldest % self.tokens.shape[0],
            "rng_state": self._rng.bit_generator.state,
            "normalisation_factor": self.normalisation_factor.tolist(),
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restart the stream at ``state``: drop the live cycle (no rewind),
        reset the permutation and refill from the saved token position."""
        self._cyc_inflight = []
        self._cyc_seq_done = 0
        self._perm = np.arange(self.buffer_size)
        self.token_pointer = int(state["token_pointer"])
        self._global_seq = self.token_pointer
        self._rng.bit_generator.state = state["rng_state"]
        if state.get("normalisation_factor") is None:
            self.first = True
            self._filled = False
            self.ensure_filled()
            return
        self.normalisation_factor = np.asarray(state["normalisation_factor"], np.float32)
        self.first = True
        self.refresh()

    def ensure_filled(self) -> None:
        """Calibrate and fill a lazy buffer that no restore filled."""
        if not self._filled:
            self.normalisation_factor = self._estimate_norm_scaling_factors()
            self.refresh()

    def close(self) -> None:
        """Nothing to stop (the synchronous path has no worker threads)."""


class QuantPairedActivationBuffer(PairedActivationBuffer):
    """The replay store in block-scaled int8 plus f32 scales, in host RAM
    or on the device as :class:`PairedActivationBuffer`'s. Each chunk's
    rows are quantized on the harvest device (K11 on the card) before they
    move to the store; serving gathers and dequantizes."""

    def _alloc_store(self) -> None:
        cfg = self.cfg
        nb = quant.n_blocks(cfg.d_in, cfg.quant_block)
        self._store_q = torch.zeros((self.buffer_size, cfg.n_sources, cfg.d_in),
                                    dtype=torch.int8, device=self.store_device)
        self._store_scale = torch.zeros((self.buffer_size, cfg.n_sources, nb),
                                        dtype=torch.float32, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return self._store_q, self._store_scale

    @property
    def _store(self) -> torch.Tensor:
        """Dequantized bf16 view of the whole store (tests and analysis)."""
        return quant.dequantize_blocks(self._store_q, self._store_scale, torch.bfloat16)

    def _write_rows(self, positions: np.ndarray, rows: torch.Tensor) -> None:
        q, s = quant.quantize_rows(rows, self.cfg.quant_block)
        hostops.scatter_rows(self._store_q, positions, q.to(self.store_device))
        hostops.scatter_rows(self._store_scale, positions, s.to(self.store_device))

    def _read_rows(self, idx: np.ndarray, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return quant.dequantize_blocks(hostops.gather_rows(self._store_q, idx),
                                       hostops.gather_rows(self._store_scale, idx), dtype)

    def next(self) -> torch.Tensor:
        # as the JAX package's stores do it: the device store's serve
        # dequantizes to bf16 and then scales in f32, the host store's
        # dequantizes straight to f32 (ROADMAP C5)
        dtype = torch.bfloat16 if self.cfg.buffer_device == "hbm" else torch.float32
        out = self._read_rows(self._next_idx(), dtype).float()
        out *= torch.as_tensor(self.normalisation_factor, device=out.device)[None, :, None]
        self._after_serve()
        return out


# the JAX package's class names: the store's place follows cfg.buffer_device
DevicePairedActivationBuffer = PairedActivationBuffer
QuantDevicePairedActivationBuffer = QuantPairedActivationBuffer


def make_buffer(cfg: CrossCoderConfig, lm_cfg, model_params, tokens,
                **kwargs) -> PairedActivationBuffer:
    """The replay buffer for ``cfg.quant_buffer`` (bf16 or block-scaled
    int8 rows), its store in host RAM or on the device as
    ``cfg.buffer_device`` says."""
    cls = QuantPairedActivationBuffer if cfg.quant_buffer else PairedActivationBuffer
    return cls(cfg, lm_cfg, model_params, tokens, **kwargs)

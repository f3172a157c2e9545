"""Paired-activation replay buffer, ported from
:mod:`crosscoder_tpu.data.buffer` (the synchronous path).

Harvest → calibrate → store → shuffle → serve, as the JAX package does it:

- **Harvest** on the device: every model's hook activations for a chunk of
  ``model_batch_size`` token sequences, ``[C, S, n_sources, d_in]`` in
  bf16; BOS rows are dropped before storing. The padded runtime
  (``harvest_runtime="padded"``) runs the padded capture forward, the
  refill's chunks cut into :class:`~crosscoder_tpu_torch.models.lm.SegmentedHarvest`
  quanta of a few blocks so a chunk's forwards spread over several train
  steps; the paged runtime (``"paged"``) packs each chunk's documents by
  their real lengths (trailing PAD ids) into a token plane and attends
  through K1 (:func:`~crosscoder_tpu_torch.models.lm.run_with_cache_multi_paged`,
  ``pad_mode="wrap"``: positions past a document's end repeat its own
  rows, so no stored row is all zeros), one dispatch a chunk;
  :meth:`PairedActivationBuffer.padding_efficiency` reports the real-token
  share.
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
- **Refill overlap** (``refill_overlap="on"``): a steady-state cycle
  harvests into spare store rows (``refill_frac`` of the buffer more)
  while the live rows keep serving, from a dispatcher thread
  (:class:`~crosscoder_tpu_torch.utils.pipeline.QuantumDispatcher`) that
  spends the pacing credit each serve posts, launching on the stream the
  buffer was built on; at the cycle's end a logical→physical row map
  swaps, so no row moves and the served stream is byte-identical to
  overlap off. A full fill (the first, a restore) stays in place. Where
  the refill issues collectives (the mesh stores, ``shard_lm`` or
  tensor-parallel params, ``seq_shards``, more than one rank) no thread
  starts: each serve pumps its credit inline, in the same count-based
  order on every rank, as the JAX package does on a mesh.
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

Across ranks (a ``mesh``, :mod:`crosscoder_tpu_torch.parallel.mesh`),
:func:`make_buffer` picks, under ``buffer_device="hbm"`` with a ``data``
axis wider than 1, the store sharded over ``data``
(:class:`MeshPairedActivationBuffer`, :class:`QuantMeshPairedActivationBuffer`):
each rank holds ``ceil(rows / n)`` rows of it, harvests its share of each
chunk's sequences (or, under ``seq_shards``, the whole chunk through the
sequence-parallel forward) and serves its own rows of every batch. The
harvest forward takes tensor-parallel LM params (``shard_lm``) as it
takes whole ones. A host store refuses more than one rank, as the JAX
package's does.

Every store serves several consumers (the fleet's tenants) from one
stream: :meth:`PairedActivationBuffer.next_raw_for` gathers once a stream
position and hands the same batch to each consumer there
(:mod:`crosscoder_tpu_torch.data.fanout`).
"""

from __future__ import annotations

import sys
from typing import Any, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import hostops
from crosscoder_tpu_torch.data import tokens as tokens_mod
from crosscoder_tpu_torch.data.fanout import FanOut
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.parallel import collectives as coll
from crosscoder_tpu_torch.utils import pipeline
from crosscoder_tpu_torch.utils.device import resolve_device
from crosscoder_tpu_torch.utils.pipeline import DEFAULT_DEPTH, drive


def _token_norms(acts: torch.Tensor) -> torch.Tensor:
    """The f32 norm of every row of a chunk ``[C, S, n, d]``: ``[C, S, n]``."""
    return torch.linalg.norm(acts.float(), dim=-1)


def _masked_norm_sum(norms: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Per-source sum of token norms ``[C, S, n]`` over the first
    ``n_valid`` sequences, f32 ``[n]``, on the chunk's device."""
    mask = (torch.arange(norms.shape[0], device=norms.device) < n_valid)[:, None, None]
    return (norms * mask).sum(dim=(0, 1))


class _SingleDispatchJob:
    """A harvest already dispatched in full, with
    :class:`~crosscoder_tpu_torch.models.lm.SegmentedHarvest`'s step
    protocol (the paged harvest: one dispatch a chunk)."""

    def __init__(self, result: torch.Tensor) -> None:
        self._result = result

    def step(self) -> bool:
        return False

    def step_many(self, quanta: int) -> tuple[int, bool]:
        return 1, False              # one quantum of the pacing budget

    def inflight(self) -> list[torch.Tensor]:
        return [self._result]

    def result(self) -> torch.Tensor:
        return self._result


class PairedActivationBuffer(FanOut):
    """Serves shuffled paired activations for crosscoder training, from a
    bf16 store in host RAM, or on ``device`` under ``buffer_device="hbm"``
    (batches are then served as device tensors, which the trainer does not
    copy again).

    ``model_params``: one LM param dict per model (``len == cfg.n_models``),
    on ``device`` (tensor-parallel ones too, :func:`lm.shard_params_tp`);
    ``tokens``: ``[n_seqs, seq_len]`` token ids. ``mesh``: the rank grid
    (needed for ``seq_shards > 1``, whose ``data`` axis carries the
    sequence). Runs on ``cuda`` unless ``device`` names another device.
    ``lazy=True`` defers calibration and the first fill to
    :meth:`load_state_dict`. ``chaos``: a
    :class:`~crosscoder_tpu_torch.resilience.Chaos` whose ``on_harvest``
    runs at the start of every chunk's harvest job (the first fill's
    chunks count too), as the JAX buffer's.
    """

    PIPELINE_DEPTH = DEFAULT_DEPTH
    serves_local_rows = False       # each serve is the global batch

    def __init__(self, cfg: CrossCoderConfig, lm_cfg: lm.LMConfig,
                 model_params: Sequence[lm.LMParams], tokens, lazy: bool = False,
                 device=None, mesh=None, chaos=None) -> None:
        from crosscoder_tpu_torch.parallel import multihost

        if cfg.buffer_device == "host" and multihost.world_size() > 1:
            # before anything else: every chunk would funnel through one rank
            raise ValueError(
                "buffer_device='host' cannot run on a multi-process mesh "
                "(chunks funnel through one process's RAM); use "
                "buffer_device='hbm' — the mesh-sharded store")
        if len(model_params) != cfg.n_models:
            raise ValueError(f"got {len(model_params)} param sets for n_models={cfg.n_models}")
        cfg.check_buffer()
        self.mesh = mesh
        # sequence-parallel harvest: the mesh's data axis carries the sequence
        self._seq_mesh = None
        if cfg.seq_shards > 1:
            n_data = mesh.data_size if mesh is not None else 1
            if n_data != cfg.seq_shards:
                raise ValueError(f"seq_shards {cfg.seq_shards} != mesh data axis {n_data}")
            self._seq_mesh = mesh
        self.cfg = cfg
        self.chaos = chaos              # fault injection at each harvest job; None: never called
        self.lm_cfg = lm_cfg
        self.model_params = list(model_params)
        self.device = resolve_device(device)
        self.store_device = self.device if cfg.buffer_device == "hbm" else torch.device("cpu")
        # a host store feeding a card serves its rows, and takes the
        # harvest's, through page-locked memory: the copies do not block the
        # host, and the caching host allocator hands the same blocks back
        # every serve, where new pageable arrays would be mapped afresh
        self._pin = self.store_device.type == "cpu" and self.device.type == "cuda"
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 2 or self.tokens.shape[1] != cfg.seq_len:
            raise ValueError(f"tokens must be [n_seqs, {cfg.seq_len}], got {self.tokens.shape}")
        self.hook_points = cfg.resolved_hook_points()
        rows_per_seq = cfg.seq_len - 1                     # BOS dropped
        self.buffer_batches = cfg.batch_size * cfg.buffer_mult // rows_per_seq
        self.buffer_size = self.buffer_batches * rows_per_seq
        # every harvest runs at this sequence count: a multiple of the data
        # axis a batch-sharded harvest splits (not under seq_shards, whose
        # data axis carries the sequence), ragged tails padded
        data_axis = self._harvest_split()
        self._chunk_seqs = -(-cfg.model_batch_size // data_axis) * data_axis
        self._paged = cfg.harvest_runtime == "paged"
        if self._paged and self.device.type == "cuda" and cfg.page_size not in pa.PAGE_SIZES:
            raise ValueError(f"harvest_runtime='paged' on the card attends through K1, which "
                             f"takes page_size in {pa.PAGE_SIZES}, got {cfg.page_size}")
        self._plane_multiple = 1
        self._paged_valid_tokens = 0            # padding-efficiency telemetry
        self._paged_total_tokens = 0
        # refill overlap: one steady-state cycle harvests into spare rows
        self._overlap = cfg.refill_overlap == "on"
        self._spare_rows = self._refill_batches() * rows_per_seq if self._overlap else 0
        self._store_rows = self.buffer_size + self._spare_rows
        self._row_map = np.arange(self.buffer_size)
        self._free_rows = self.buffer_size + np.arange(self._spare_rows)
        # the dispatcher thread launches on the stream the buffer was built on
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._dispatcher = (pipeline.QuantumDispatcher(self._pump_locked)
                            if self._overlap and not self._collective_refill() else None)
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
        self._cyc_job: tuple | None = None
        # real serves (next, next_raw): the fan-out's stream position
        self._serve_seq = 0
        self._init_fanout()
        if not lazy:
            self.normalisation_factor = self._estimate_norm_scaling_factors()
            self.refresh()

    def _collective_refill(self) -> bool:
        """Whether the harvest (tensor-parallel, sequence-parallel) or the
        store (mesh-sharded) issues collectives: a dispatcher thread would
        launch them beside the main thread's, in an order the ranks do not
        share, so the refill overlap pumps its credit inline there (JAX's
        rule: no dispatcher thread on a mesh store or on many processes)."""
        from crosscoder_tpu_torch.parallel import multihost

        return bool(self.cfg.shard_lm or self._seq_mesh is not None or self.serves_local_rows
                    or multihost.world_size() > 1
                    or any(lm.TP_KEY in p for p in self.model_params))

    # ------------------------------------------------------------------
    # store

    def _harvest_split(self) -> int:
        """Ranks a chunk's sequences are split over (1: every rank harvests
        the whole chunk)."""
        return 1

    def _alloc_store(self) -> None:
        # buffer_size rows, plus the overlap engine's spare rows
        self._store = torch.zeros((self._store_rows, self.cfg.n_sources, self.cfg.d_in),
                                  dtype=torch.bfloat16, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return (self._store,)

    def store_nbytes(self) -> int:
        """Bytes the replay store occupies on :attr:`store_device`."""
        return sum(t.numel() * t.element_size() for t in self._store_tensors())

    def _to_store(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on :attr:`store_device` (off a card into a host store
        through page-locked memory)."""
        if self._pin and t.device.type == "cuda":
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        return t.to(self.store_device)

    def _write_rows(self, positions: np.ndarray, rows: torch.Tensor) -> None:
        """Store harvested bf16 rows ``[r, n_sources, d_in]`` (on the
        harvest device) at store rows ``positions``."""
        hostops.scatter_rows(self._store, positions, self._to_store(rows))

    def _read_rows(self, idx: np.ndarray) -> torch.Tensor:
        """Store rows ``idx`` as bf16 on :attr:`store_device` (page-locked
        when a host store feeds a card)."""
        return hostops.gather_rows(self._store, idx, pin=self._pin)

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
        model-major), through the configured runtime. Asynchronous on the
        card."""
        if self._paged:
            return self._harvest_dev_paged(padded_tokens)
        tok = torch.as_tensor(np.asarray(padded_tokens, dtype=np.int64), device=self.device)
        if self._seq_mesh is not None:
            # the sequence split over data (ring attention); the capture
            # comes back stitched, in the padded layout
            acts = lm.run_with_cache_multi_seq_parallel(
                self.model_params, tok, self.lm_cfg, self.hook_points, self._seq_mesh)
        else:
            acts = lm.run_with_cache_multi(self.model_params, tok, self.lm_cfg,
                                           self.hook_points)
        return acts.to(torch.bfloat16)

    def _harvest_dev_paged(self, padded_tokens: np.ndarray) -> torch.Tensor:
        """The paged harvest of one chunk: lengths from the trailing PAD
        ids, the documents packed into a token plane, ragged attention
        (K1 on the card), positions past each length refilled from the
        document's own rows (``pad_mode="wrap"``); the padded layout's
        shape and dtype."""
        lengths = tokens_mod.valid_lengths(padded_tokens)
        self._paged_valid_tokens += int(lengths.sum())
        self._paged_total_tokens += int(padded_tokens.size)
        return lm.run_with_cache_multi_paged(
            self.model_params, padded_tokens, lengths, self.lm_cfg, self.hook_points,
            page_size=self.cfg.page_size, row_multiple=self._plane_multiple, pad_mode="wrap",
            out_dtype=torch.bfloat16)

    def padding_efficiency(self) -> float | None:
        """Real tokens over all tokens harvested so far by the paged
        runtime; None under the padded runtime. The trainer logs it as
        ``harvest/padding_efficiency``."""
        if not self._paged or self._paged_total_tokens == 0:
            return None
        return self._paged_valid_tokens / self._paged_total_tokens

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
                yield _masked_norm_sum(self._chunk_norms(self._harvest_dev(padded)), n)

        def drain(part: torch.Tensor) -> None:
            nonlocal sums
            sums += part.cpu().numpy().astype(np.float64)

        drive(produced(), drain, depth=self.PIPELINE_DEPTH)
        mean_norm = sums / max(count, 1)
        return (np.sqrt(cfg.d_in) / mean_norm).astype(np.float32)

    def _chunk_norms(self, acts: torch.Tensor) -> torch.Tensor:
        """Token norms ``[C, S, n]`` of a whole harvested chunk."""
        return _token_norms(acts)

    def refresh(self) -> None:
        """Synchronous refill (first fill, resume, tests): the whole buffer
        the first time, ``refill_frac`` of it after."""
        self._quiesce_dispatch()
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
    # once w + r <= pointer + tail. A chunk's harvest is a job of quanta
    # (SegmentedHarvest: a few blocks of one model; the paged harvest: the
    # whole chunk), dispatched `_cyc_segs_per_serve` quanta a serve, at
    # most PIPELINE_DEPTH chunks in flight; only the drain waits on the
    # write-safety rule.
    #
    # With refill_overlap a steady-state cycle is a shadow cycle: its rows
    # land in spare physical rows, drains need no safety gate (one chunk
    # of lag), the dispatcher thread spends the serves' credit, and the
    # finish swaps the row map.

    def _begin_cycle(self, num_batches: int | None = None) -> None:
        rows_per_seq = self.cfg.seq_len - 1
        # a forced refresh mid-cycle abandons the cycle: nothing it
        # dispatched has been served, so rewind the token stream over it
        dropped = self._cyc_seq_done
        if dropped:
            self.token_pointer = (self.token_pointer - dropped) % self.tokens.shape[0]
            self._global_seq -= dropped
            self._cyc_inflight = []
            self._cyc_job = None
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
        self._cyc_job = None            # (job, n, seq_globals, woff) mid-dispatch
        n_chunks = -(-num_batches // self._chunk_seqs)
        serves = max(1, trigger // b + 1)
        self._cyc_segs_per_serve = -(-n_chunks * self._segs_per_chunk() // serves)
        # a shadow cycle fits the spare rows; full fills stay in place
        self._cyc_shadow = self._overlap and self._cyc_target <= self._spare_rows
        self._cyc_phys = self._free_rows[: self._cyc_target] if self._cyc_shadow else None
        # a shadow cycle's provenance, applied at the swap
        self._cyc_src = np.empty(self._cyc_target, np.int64) if self._cyc_shadow else None

    def _segs_per_chunk(self) -> int:
        """Dispatch quanta one chunk's harvest costs (the pacing unit)."""
        if self._paged or self._seq_mesh is not None:
            return 1
        return lm.SegmentedHarvest.count(self.lm_cfg, self.hook_points, len(self.model_params))

    def _harvest_job(self, padded_tokens: np.ndarray):
        """A steppable harvest of one fixed-shape chunk: the padded
        runtime's :class:`~crosscoder_tpu_torch.models.lm.SegmentedHarvest`
        (nothing dispatched yet), or the paged harvest dispatched whole.
        The chaos hook runs first: an injected failure leaves the chunk's
        tokens taken and nothing dispatched, as in the JAX buffer."""
        if self.chaos is not None:
            self.chaos.on_harvest()
        if self._paged or self._seq_mesh is not None:
            return _SingleDispatchJob(self._harvest_dev(padded_tokens))
        tok = torch.as_tensor(np.asarray(padded_tokens, dtype=np.int64), device=self.device)
        return lm.SegmentedHarvest(self.model_params, tok, self.lm_cfg, self.hook_points,
                                   out_dtype=torch.bfloat16)

    def _cyc_logical(self, woff: int, n_rows: int) -> np.ndarray:
        """Logical store rows for cycle write offsets ``[woff, woff + n_rows)``."""
        j = np.arange(woff, woff + n_rows)
        order = np.where(j < self._cyc_tail, self._cyc_rot + j, j - self._cyc_tail)
        return self._perm[order]

    def _cyc_positions(self, woff: int, n_rows: int) -> np.ndarray:
        """Physical rows a drain writes: a shadow cycle's spare rows, else
        the live rows of the logical targets (``_row_map`` is the identity
        with overlap off)."""
        if self._cyc_shadow:
            return self._cyc_phys[woff: woff + n_rows]
        logical = self._cyc_logical(woff, n_rows)
        return self._row_map[logical] if self._overlap else logical

    def _record_src(self, woff: int, n_rows: int, seq_globals: np.ndarray) -> None:
        """Per-row provenance of a drained chunk; a shadow cycle defers it
        to the swap, so an abandoned one leaves ``_src_global`` untouched."""
        src = np.repeat(seq_globals, self.cfg.seq_len - 1)
        if self._cyc_shadow:
            self._cyc_src[woff: woff + n_rows] = src
        else:
            self._src_global[self._cyc_logical(woff, n_rows)] = src

    def _create_job(self) -> tuple:
        """Open the next chunk's job and count its sequences as dispatched
        (the token stream advances here, so an abandon-rewind covers a job
        mid-dispatch as it covers landed chunks)."""
        n_seqs = min(self._chunk_seqs, self._cyc_batches - self._cyc_seq_done)
        seq_globals = self._global_seq + np.arange(n_seqs)
        padded, n = self._pad_chunk(self._take_tokens(n_seqs))
        entry = (self._harvest_job(padded), n, seq_globals, self._cyc_write)
        self._cyc_seq_done += n_seqs
        self._cyc_write += n_seqs * (self.cfg.seq_len - 1)
        return entry

    def _step_job(self) -> bool:
        """Advance the harvest by one dispatch quantum: open a job if none
        is open (unless the cycle is fully dispatched or PIPELINE_DEPTH
        chunks are in flight), else step it; a finished job joins the
        drain queue. False when nothing can be dispatched now."""
        return self._dispatch_quanta(1) > 0

    def _dispatch_quanta(self, quanta: int) -> int:
        """Spend up to ``quanta`` dispatch credit on the open job, at most
        ``cfg.refill_dispatch_batch`` quanta in one block loop
        (:meth:`SegmentedHarvest.step_many`). Returns the credit spent; 0
        when nothing is dispatchable now."""
        if self._cyc_job is None:
            if (self._cyc_seq_done >= self._cyc_batches
                    or len(self._cyc_inflight) + 1 > self.PIPELINE_DEPTH):
                return 0
            self._cyc_job = self._create_job()
        job, n, seq_globals, woff = self._cyc_job
        used, alive = job.step_many(min(quanta, max(1, self.cfg.refill_dispatch_batch)))
        pipeline.finish_on_cpu(job.inflight())
        if not alive:
            self._cyc_inflight.append((job.result(), n, seq_globals, woff))
            self._cyc_job = None
        return max(used, 1)

    def _drain_one(self) -> None:
        cfg = self.cfg
        acts_dev, n, seq_globals, woff = self._cyc_inflight.pop(0)
        # the real sequences only, BOS dropped
        rows = acts_dev[:n, 1:].reshape(-1, cfg.n_sources, cfg.d_in)
        self._write_rows(self._cyc_positions(woff, rows.shape[0]), rows)
        self._record_src(woff, rows.shape[0], seq_globals)
        self._cyc_drained += rows.shape[0]

    def _head_drainable(self) -> bool:
        """The oldest in-flight chunk may land: a shadow cycle writes spare
        rows only, so it keeps one chunk of lag; otherwise its rows are free
        once the read pointer (plus the unserved tail) covers them."""
        if not self._cyc_inflight:
            return False
        if self._cyc_shadow:
            return len(self._cyc_inflight) > 1
        _, n, _, woff = self._cyc_inflight[0]
        return woff + n * (self.cfg.seq_len - 1) <= self.pointer + self._cyc_tail

    def _overlap_pump(self, credit: int) -> None:
        """A shadow cycle's progress for ``credit`` quanta: dispatch them
        (batched), then land every chunk past the drain lag."""
        with trace.span("refill_dispatch", credit=credit):
            while credit > 0:
                used = self._dispatch_quanta(credit)
                if used == 0:
                    break
                credit -= used
            while self._head_drainable():
                with trace.span("harvest"):
                    self._drain_one()

    def _pump_locked(self, credit: int) -> None:
        """The dispatcher thread's pump: launches on the buffer's stream
        (a thread starts on its device's default stream, not the caller's)."""
        with pipeline.sharded_program_guard():
            if self._stream is None:
                self._overlap_pump(credit)
                return
            with torch.cuda.stream(self._stream):
                self._overlap_pump(credit)

    def _quiesce_dispatch(self) -> None:
        """Wait out the dispatcher's work before cycle state changes under
        it (forced refresh, restore); re-raises its error, if any."""
        if self._dispatcher is not None:
            self._dispatcher.drain()

    def _advance_cycle(self) -> None:
        """One serve's worth of refill: the paced dispatch quanta, and every
        chunk whose rows are free lands. A shadow cycle hands the credit to
        the dispatcher thread, or pumps it here where there is none (a
        refill that issues collectives, or a closed thread): the same
        count-based schedule, so every rank dispatches and drains alike."""
        credit = self._cyc_segs_per_serve
        if self._cyc_shadow:
            if self._dispatcher is not None:
                self._dispatcher.submit(credit)
            else:
                self._overlap_pump(credit)
            return
        while credit > 0 and self._step_job():
            credit -= 1
        while self._head_drainable():
            with trace.span("harvest"):
                self._drain_one()

    def _finish_cycle(self) -> None:
        """Dispatch and land what is left of the cycle, swap a shadow
        cycle's rows in, re-shuffle, reset the read pointer and open the
        next cycle."""
        self._quiesce_dispatch()
        with trace.span("refill", target_rows=self._cyc_target):
            while self._cyc_seq_done < self._cyc_batches or self._cyc_job is not None:
                advanced = (self._dispatch_quanta(1 << 30) if self._cyc_shadow
                            else self._step_job())
                if not advanced:            # depth window full: free a slot
                    with trace.span("harvest"):
                        self._drain_one()
            while self._cyc_inflight:
                with trace.span("harvest"):
                    self._drain_one()
        if not self._cyc_drained == self._cyc_write == self._cyc_target:
            raise RuntimeError(f"refill cycle ended with {self._cyc_drained} rows landed, "
                               f"{self._cyc_write} dispatched, {self._cyc_target} wanted")
        if self._cyc_shadow:
            # the swap: the spare rows become the logical content and the
            # displaced rows the next spare region; no row moves
            logical = self._cyc_logical(0, self._cyc_target)
            old_phys = self._row_map[logical].copy()
            self._row_map[logical] = self._cyc_phys
            self._free_rows = np.concatenate([old_phys, self._free_rows[self._cyc_target:]])
            self._src_global[logical] = self._cyc_src
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
        return self._row_map[idx] if self._overlap else idx     # logical → physical

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

    def _stream_head(self) -> int:
        return self._serve_seq

    def next_raw_for(self, name: str) -> torch.Tensor:
        """The raw batch at consumer ``name``'s cursor: one
        :meth:`next_raw` a stream position, the same tensor for every
        consumer there."""
        return self._serve_for(name, self.next_raw)

    def _after_serve(self) -> None:
        self._serve_seq += 1
        self._advance_cycle()
        if self.pointer > self.buffer_size // 2 - self.cfg.batch_size:
            self._finish_cycle()

    # ------------------------------------------------------------------
    # resume

    def state_dict(self) -> dict[str, Any]:
        """Stream-resume state (the JAX package's format): the token
        position of the oldest unserved row, the shuffle generator's state
        and the norm factors (with fan-out consumers attached, how far each
        sits behind the head). A save before the first fill records a
        from-scratch state."""
        if not self._filled:
            return {"token_pointer": 0, "rng_state": self._rng.bit_generator.state,
                    "normalisation_factor": None, **self._consumer_state()}
        oldest = (int(self._suffix_min_src[self.pointer]) if self.pointer < self.buffer_size
                  else self._global_seq)
        return {
            "token_pointer": oldest % self.tokens.shape[0],
            "rng_state": self._rng.bit_generator.state,
            "normalisation_factor": self.normalisation_factor.tolist(),
            **self._consumer_state(),
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        """Restart the stream at ``state``: quiesce the dispatcher, drop the
        live cycle (no rewind), reset the permutation and the row map and
        refill from the saved token position; every fan-out consumer starts
        again at the restored head."""
        self._quiesce_dispatch()
        self._realign_consumers(state)
        self._cyc_inflight = []
        self._cyc_job = None
        self._cyc_seq_done = 0
        self._perm = np.arange(self.buffer_size)
        if self._overlap:
            self._row_map = np.arange(self.buffer_size)
            self._free_rows = self.buffer_size + np.arange(self._spare_rows)
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
        """Stop the refill dispatcher thread (none with overlap off).
        Idempotent; drops in-flight work: the buffer is torn down after."""
        if self._dispatcher is not None:
            self._dispatcher.close()
            self._dispatcher = None

    # ------------------------------------------------------------------
    # elastic re-mesh (resilience/elastic.py)

    def prepare_reshard(self) -> None:
        """Quiesce the refill ahead of a membership change (the elastic
        shrink): drain and stop the dispatcher (an error it reports is
        printed and dropped: its work is discarded) and drop the in-flight
        harvest chunks. The LM params stay where they are: device tensors
        outlive the old world's groups, unlike the JAX backend reset's; the
        grid and the tensor-parallel params' group are let go, so that
        leaving the old world closes its groups. The store is not kept:
        :meth:`reshard` refills it from the stream position, which is the
        state."""
        try:
            self._quiesce_dispatch()
        except Exception as e:  # noqa: BLE001 — a pump torn with the world; its work is dropped
            print(f"[crosscoder_tpu_torch] reshard: dispatcher drain failed "
                  f"({type(e).__name__}: {e})"[:300], flush=True, file=sys.stderr)
        self.close()
        self._cyc_inflight = []
        self._cyc_job = None
        self.mesh = None
        self.model_params = [p if lm.TP_KEY not in p else
                             {**p, lm.TP_KEY: lm.TPGroup(None, p[lm.TP_KEY].rank)}
                             for p in self.model_params]

    def _retarget_tp(self, params: lm.LMParams) -> lm.LMParams:
        """Tensor-parallel params pointed at the new grid's ``model`` group.
        The survivors keep their model ranks (the TP width is kept and they
        are the first ranks), so each rank's slices stay its own."""
        tp = params.get(lm.TP_KEY)
        if tp is None:
            return params
        if self.mesh is None or self.mesh.model_rank != tp.rank:
            raise ValueError(
                "reshard: tensor-parallel LM params keep their slices only on a grid where "
                f"this rank keeps its model index {tp.rank}")
        return {**params, lm.TP_KEY: lm.TPGroup(self.mesh.model_group, tp.rank)}

    def reshard(self, mesh, refill: bool = True) -> None:
        """Re-derive every grid-coupled piece of the buffer for ``mesh`` (the
        JAX ``reshard``'s ``batch_sharding``; ``None`` off a grid): the
        harvest chunk rounding, the store allocation (a mesh store's shard
        of the new ``data`` axis), the permutation, the row map and the
        spare rows, the fan-out cache, the dispatcher thread (where the new
        world allows one) and the tensor-parallel params' group. With
        ``refill=True`` the store then refills from the live stream's
        position, so the served stream continues as a fresh buffer restored
        from :meth:`state_dict` would; ``refill=False`` leaves the buffer
        empty for the caller's :meth:`load_state_dict` (the elastic restore
        replays a save's position)."""
        if self.cfg.seq_shards > 1:
            raise ValueError(
                "reshard with seq_shards > 1 is unsupported (the mesh data axis carries the "
                "sequence there, not the batch)")
        if self.serves_local_rows and mesh is None:
            raise ValueError(f"{type(self).__name__} needs the rank grid (mesh=)")
        snap = self.state_dict() if refill else None
        self.mesh = mesh
        self.model_params = [self._retarget_tp(p) for p in self.model_params]
        data_axis = self._harvest_split()
        self._chunk_seqs = -(-self.cfg.model_batch_size // data_axis) * data_axis
        self._cyc_inflight = []
        self._cyc_job = None
        self._cyc_seq_done = 0
        self._perm = np.arange(self.buffer_size)
        self._row_map = np.arange(self.buffer_size)
        self._free_rows = self.buffer_size + np.arange(self._spare_rows)
        self.pointer = 0
        self._src_global = np.zeros(self.buffer_size, dtype=np.int64)
        self.first = True
        self._filled = False
        self._fanout_batch, self._fanout_seq = None, -1
        self._alloc_store()
        if self._overlap and self._dispatcher is None and not self._collective_refill():
            self._dispatcher = pipeline.QuantumDispatcher(self._pump_locked)
        if refill:
            self.load_state_dict(snap)


class QuantPairedActivationBuffer(PairedActivationBuffer):
    """The replay store in block-scaled int8 plus f32 scales, in host RAM
    or on the device as :class:`PairedActivationBuffer`'s. Each chunk's
    rows are quantized on the harvest device (K11 on the card) before they
    move to the store; serving gathers and dequantizes."""

    def _alloc_store(self) -> None:
        cfg = self.cfg
        nb = quant.n_blocks(cfg.d_in, cfg.quant_block)
        self._store_q = torch.zeros((self._store_rows, cfg.n_sources, cfg.d_in),
                                    dtype=torch.int8, device=self.store_device)
        self._store_scale = torch.zeros((self._store_rows, cfg.n_sources, nb),
                                        dtype=torch.float32, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return self._store_q, self._store_scale

    @property
    def _store(self) -> torch.Tensor:
        """Dequantized bf16 view of the whole store (tests and analysis)."""
        return quant.dequantize_blocks(self._store_q, self._store_scale, torch.bfloat16)

    def _write_rows(self, positions: np.ndarray, rows: torch.Tensor) -> None:
        q, s = quant.quantize_rows(rows, self.cfg.quant_block)
        hostops.scatter_rows(self._store_q, positions, self._to_store(q))
        hostops.scatter_rows(self._store_scale, positions, self._to_store(s))

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


# ---------------------------------------------------------------------------
# the store sharded over the mesh's data axis


class MeshPairedActivationBuffer(PairedActivationBuffer):
    """The replay store on the device, sharded over the ``data`` axis of
    ``mesh`` on its row dimension: data rank ``d`` holds rows ``[d·L,
    (d+1)·L)``, ``L = ceil(store rows / n)`` (the store padded to ``n·L``;
    no permutation entry reaches the padding). The permutation, the cycle
    accounting, the provenance and :meth:`state_dict` are the host-side
    state of every buffer, identical on every rank; only the rows move
    differently:

    - **refill**: each data rank harvests its ``_chunk_seqs / n``
      sequences of a chunk (under ``seq_shards`` every rank runs the whole
      chunk through the sequence-parallel forward instead); the chunk's
      rows are all-gathered over ``data`` and each rank writes the
      positions that fall in its shard;
    - **serve**: each rank gathers the batch's rows it holds, zeroes the
      others, and a reduce-scatter over ``data`` leaves it its ``B/n``
      rows of the batch (exact: the contributions are disjoint), so each
      serve is this rank's rows (:attr:`serves_local_rows`);
    - **norm calibration**: the token norms of a chunk are all-gathered,
      so every rank sums the whole chunk's norms as one rank does.

    Every rank must call every method that moves rows (a serve, a refill,
    :meth:`load_state_dict`), in the same order. ``refill_overlap="on"``
    harvests into the spare rows each rank's shard holds past the live
    ones, pumped inline at each serve (no dispatcher thread).
    """

    serves_local_rows = True

    def __init__(self, cfg: CrossCoderConfig, lm_cfg, model_params, tokens, lazy: bool = False,
                 device=None, mesh=None, chaos=None) -> None:
        if mesh is None:
            raise ValueError(f"{type(self).__name__} needs the rank grid (mesh=)")
        n = mesh.data_size
        if cfg.batch_size % n:
            raise ValueError(f"batch_size {cfg.batch_size} must divide by the mesh data "
                             f"axis {n} for the sharded-store serve path")
        super().__init__(cfg, lm_cfg, model_params, tokens, lazy=lazy, device=device, mesh=mesh,
                         chaos=chaos)

    @property
    def _group(self):
        return self.mesh.data_group

    def _harvest_split(self) -> int:
        return 1 if self._seq_mesh is not None else self.mesh.data_size

    def _mesh_geometry(self) -> None:
        n = self.mesh.data_size
        if self._seq_mesh is None and self._chunk_seqs % n:
            raise ValueError(
                f"harvest chunk of {self._chunk_seqs} seqs must divide by the mesh data axis "
                f"{n} for the batch-sharded scatter (model_batch_size="
                f"{self.cfg.model_batch_size})")
        self._rows_local = -(-self._store_rows // n)
        self._row0 = self.mesh.data_rank * self._rows_local

    def _alloc_store(self) -> None:
        self._mesh_geometry()
        self._store_dev = torch.zeros((self._rows_local, self.cfg.n_sources, self.cfg.d_in),
                                      dtype=torch.bfloat16, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return (self._store_dev,)

    @property
    def _store(self) -> torch.Tensor:
        """The whole LOGICAL store on every rank (tests and analysis; a
        collective every rank must join)."""
        whole = [coll.all_gather_cat(t, 0, self._group) for t in self._store_tensors()]
        return self._decode(whole)[torch.as_tensor(self._row_map)]

    # -- harvest on this rank's share ------------------------------------

    def _my_tokens(self, padded_tokens: np.ndarray) -> np.ndarray:
        if self._seq_mesh is not None:
            return padded_tokens
        c = self._chunk_seqs // self.mesh.data_size
        return padded_tokens[self.mesh.data_rank * c:(self.mesh.data_rank + 1) * c]

    def _harvest_dev(self, padded_tokens: np.ndarray) -> torch.Tensor:
        """This rank's share of a chunk's harvest (the whole chunk under
        ``seq_shards``)."""
        return super()._harvest_dev(self._my_tokens(padded_tokens))

    def _harvest_job(self, padded_tokens: np.ndarray):
        if self._paged or self._seq_mesh is not None:       # _harvest_dev cuts the share
            return super()._harvest_job(padded_tokens)
        return super()._harvest_job(self._my_tokens(padded_tokens))

    def _chunk_norms(self, acts: torch.Tensor) -> torch.Tensor:
        norms = _token_norms(acts)
        if self._seq_mesh is not None:
            return norms
        return coll.all_gather_cat(norms, 0, self._group)

    # -- rows in and out ---------------------------------------------------

    def _encode(self, rows: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Harvested bf16 rows in the store's format."""
        return (rows,)

    def _decode(self, parts) -> torch.Tensor:
        """Stored parts back to bf16 rows."""
        return parts[0]

    def _drain_one(self) -> None:
        cfg = self.cfg
        acts_dev, n, seq_globals, woff = self._cyc_inflight.pop(0)
        rows = acts_dev[:, 1:].reshape(-1, cfg.n_sources, cfg.d_in)       # BOS dropped
        parts = self._encode(rows)
        if self._seq_mesh is None:       # every rank's share, in sequence order
            parts = [coll.all_gather_cat(t, 0, self._group) for t in parts]
        n_rows = n * (cfg.seq_len - 1)   # the real sequences' rows
        pos = self._cyc_positions(woff, n_rows) - self._row0
        mine = np.nonzero((pos >= 0) & (pos < self._rows_local))[0]
        if mine.size:
            sel = torch.as_tensor(mine, device=rows.device)
            for store, t in zip(self._store_tensors(), parts):
                hostops.scatter_rows(store, pos[mine], t[:n_rows].index_select(0, sel))
        self._record_src(woff, n_rows, seq_globals)
        self._cyc_drained += n_rows

    def _gather_local(self, idx: np.ndarray) -> list[torch.Tensor]:
        """This rank's rows of the batch ``idx``, in the store's parts."""
        li = np.asarray(idx, np.int64) - self._row0
        hit = (li >= 0) & (li < self._rows_local)
        hit_t = torch.as_tensor(hit, device=self.store_device)[:, None, None]
        out = []
        for store in self._store_tensors():
            rows = hostops.gather_rows(store, np.clip(li, 0, self._rows_local - 1))
            rows = torch.where(hit_t, rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
            out.append(coll.reduce_scatter(rows, self._group))
        return out

    def _read_rows(self, idx: np.ndarray) -> torch.Tensor:
        """This rank's ``B/n`` rows of the batch ``idx`` as bf16."""
        return self._decode(self._gather_local(idx))

    def next(self) -> torch.Tensor:
        """This rank's rows of one training batch, f32 with the norm
        factors applied."""
        out = self._read_rows(self._next_idx()).float()
        out *= torch.as_tensor(self.normalisation_factor, device=out.device)[None, :, None]
        self._after_serve()
        return out


class QuantMeshPairedActivationBuffer(MeshPairedActivationBuffer):
    """:class:`MeshPairedActivationBuffer` in block-scaled int8 plus f32
    scales: each rank quantizes its share of a chunk's rows (K11 on the
    card) BEFORE the all-gather, so the refill moves int8 payload and
    scales; the serve's reduce-scatter runs on the payload and the scales
    apart, and each rank dequantizes its own rows."""

    def _alloc_store(self) -> None:
        cfg = self.cfg
        self._mesh_geometry()
        nb = quant.n_blocks(cfg.d_in, cfg.quant_block)
        self._store_q = torch.zeros((self._rows_local, cfg.n_sources, cfg.d_in),
                                    dtype=torch.int8, device=self.store_device)
        self._store_scale = torch.zeros((self._rows_local, cfg.n_sources, nb),
                                        dtype=torch.float32, device=self.store_device)

    def _store_tensors(self) -> tuple[torch.Tensor, ...]:
        return self._store_q, self._store_scale

    def _encode(self, rows: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return quant.quantize_rows(rows, self.cfg.quant_block)

    def _decode(self, parts) -> torch.Tensor:
        return quant.dequantize_blocks(parts[0], parts[1], torch.bfloat16)


def make_buffer(cfg: CrossCoderConfig, lm_cfg, model_params, tokens, mesh=None,
                **kwargs) -> PairedActivationBuffer:
    """The replay buffer for ``cfg.quant_buffer`` (bf16 or block-scaled
    int8 rows), its store in host RAM or on the device as
    ``cfg.buffer_device`` says, as the JAX ``make_buffer`` picks it: on a
    ``mesh`` (default: ``cfg``'s axes over the joined process group, when
    more than one rank runs) whose ``data`` axis is wider than 1 a device
    store is the mesh-sharded one. A host store on more than one rank is a
    :class:`ValueError`, raised before any model runs. ``kwargs``
    (``lazy``, ``device``, ``chaos``) go to the class."""
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost

    if mesh is None and cfg.buffer_device == "hbm" and multihost.world_size() > 1:
        mesh = mesh_lib.mesh_from_cfg(cfg)
    if cfg.buffer_device == "hbm" and mesh is not None and mesh.data_size > 1:
        cls = QuantMeshPairedActivationBuffer if cfg.quant_buffer else MeshPairedActivationBuffer
    else:
        cls = QuantPairedActivationBuffer if cfg.quant_buffer else PairedActivationBuffer
    return cls(cfg, lm_cfg, model_params, tokens, mesh=mesh, **kwargs)

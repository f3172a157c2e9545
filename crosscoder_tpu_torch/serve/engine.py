"""Online model-diffing inference engine, ported from
:mod:`crosscoder_tpu.serve.engine`.

The request loop that turns a trained crosscoder into a service:

1. **admit**: ``submit()`` places token streams on a bounded queue
   (``cfg.serve_queue``); each request's KV pages come from a fixed
   :class:`~crosscoder_tpu_torch.data.paging.PageTable` pool, so page
   exhaustion and queue overflow both shed (:class:`Shed`,
   ``serve/shed_total``). ``cfg.serve_shed_ms`` evicts queued requests
   past their deadline.
2. **batch**: ``step()`` drains the queue into a
   :class:`~crosscoder_tpu_torch.data.paging.ContinuousBatcher` plane and
   flushes on batch-full, the ``cfg.serve_max_wait_ms`` deadline, or
   ``force``. The flushed plane is padded with length-1 documents to the
   nearest power-of-two bucket ≤ ``cfg.serve_max_batch``.
3. **prefill**: both models' paged capture forward
   (:func:`crosscoder_tpu_torch.models.lm.paged_capture`, ragged paged
   attention kernel on the card).
4. **encode**: :func:`crosscoder_tpu_torch.serve.step.encode_topk_diff`,
   fused encoder→TopK kernel plus decoder-norm diff scores; only three
   ``[B, k]`` arrays leave the device.
5. **extend**: a live request (``submit(..., keep=True)``) appends tokens
   via :meth:`PageTable.extend` and jumps to the queue front.

``queue_wait``/``prefill``/``encode`` feed ``serve/*_ms`` histograms;
prefill and encode are timed to a ``torch.cuda.synchronize()`` on the
card. PyTorch runs eagerly, so there is no compile cache: :meth:`warmup`
builds the kernels and runs each bucket once.
"""

from __future__ import annotations

import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from crosscoder_tpu_torch.data.paging import ContinuousBatcher, PageTable, pack_chunk
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.obs.registry import MetricsRegistry
from crosscoder_tpu_torch.serve import step as serve_step
from crosscoder_tpu_torch.utils.device import resolve_device

__all__ = ["InferenceEngine", "ServeResult", "Shed", "batch_buckets", "bucket_of"]


class Shed(RuntimeError):
    """429-style admission reject: queue full, deadline passed, or page
    pool exhausted. Counted in ``serve/shed_total``."""


@dataclass
class ServeResult:
    """One served request: top-k latent activations (ascending index,
    ``(0, 0)``-padded) + model-diff scores (``diff[j]`` ≈ 0: latent
    ``idx[j]`` is model-0-only, ≈ 0.5 shared, ≈ 1 model-1-only) and the
    request's latency breakdown. ``vals`` are float32 on the host (a bf16
    value converts exactly)."""

    request_id: int
    vals: np.ndarray                # [k] f32 latent activations
    idx: np.ndarray                 # [k] i32 latent indices
    diff: np.ndarray                # [k] f32 relative decoder norms
    bucket: int                     # batch bucket served under
    queue_wait_ms: float
    prefill_ms: float
    encode_ms: float
    extended: bool = False          # served off an extend ticket


@dataclass
class _Pending:
    rid: int
    tokens: np.ndarray
    t: float                        # enqueue time (engine clock)
    keep: bool = False
    extend: bool = False


@dataclass
class _Live:
    tokens: np.ndarray = field(repr=False, default=None)


def batch_buckets(max_batch: int) -> tuple[int, ...]:
    """The bucket ladder: powers of two ``1..max_batch``."""
    out, b = [], 1
    while b <= max_batch:
        out.append(b)
        b *= 2
    return tuple(out)


def bucket_of(n: int, max_batch: int) -> int:
    """Smallest ladder bucket covering ``n`` requests."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class InferenceEngine:
    """The serve loop over two (or more) LMs and one crosscoder.

    ``lm_params_seq`` and ``cc_params`` must already live on ``device``
    (``cuda`` unless the caller names another), as
    :func:`crosscoder_tpu_torch.models.lm.init_params`,
    :func:`crosscoder_tpu_torch.models.crosscoder.init_params` and the
    :mod:`crosscoder_tpu_torch.convert` loaders put them.
    """

    def __init__(
        self,
        cfg,
        lm_cfg: lm.LMConfig,
        lm_params_seq: Sequence[lm.LMParams],
        cc_params: Mapping[str, torch.Tensor],
        *,
        hook_points=None,
        norm_factors=None,
        registry: MetricsRegistry | None = None,
        clock=time.monotonic,
        device=None,
    ) -> None:
        if cfg.serve != "on":
            raise ValueError("InferenceEngine requires cfg.serve='on'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.lm_cfg = lm_cfg
        self._lm_params = tuple(lm_params_seq)
        self._cc_params = dict(cc_params)
        for what, t in [("lm params", p["embed"]) for p in self._lm_params] + [
                ("crosscoder params", self._cc_params["W_enc"])]:
            if t.device.type != self.device.type:
                raise ValueError(f"{what} live on {t.device}, the engine runs on {self.device}")
        self._hooks = tuple(
            hook_points if hook_points is not None
            else cfg.resolved_hook_points()
        )
        n_sources = len(self._lm_params) * len(self._hooks)
        self._pair = serve_step.diff_pair(n_sources, len(self._lm_params))
        norm = (np.ones(n_sources, np.float32) if norm_factors is None
                else np.asarray(norm_factors, np.float32))
        if norm.shape != (n_sources,):
            raise ValueError(
                f"norm_factors must be [{n_sources}] (one per source), "
                f"got {norm.shape}"
            )
        self._norm = torch.as_tensor(norm, device=self.device)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock
        self.buckets = batch_buckets(cfg.serve_max_batch)
        pages_per_seq = -(-cfg.seq_len // cfg.page_size)
        self._pages = PageTable(
            (cfg.serve_queue + cfg.serve_max_batch) * pages_per_seq,
            cfg.page_size,
        )
        self._batcher = ContinuousBatcher(
            cfg.seq_len, n_rows=cfg.serve_max_batch,
            max_wait_s=cfg.serve_max_wait_ms / 1e3,
        )
        self._queue: deque[_Pending] = deque()
        self._batch: list[_Pending] = []
        self._live: dict[int, _Live] = {}
        self._shed_ids: set[int] = set()
        self._next_id = 0

    # -- admission -------------------------------------------------------

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def was_shed(self, rid: int) -> bool:
        return rid in self._shed_ids

    def _shed(self, rid: int | None, reason: str):
        self.registry.count("serve/shed_total")
        if rid is not None:
            self._shed_ids.add(rid)
        raise Shed(reason)

    def _evict_stale(self, now: float) -> None:
        """Drop queued requests older than ``cfg.serve_shed_ms``: they
        would be served too late to matter, and they hold pages."""
        if self.cfg.serve_shed_ms <= 0:
            return
        limit = self.cfg.serve_shed_ms / 1e3
        kept: deque[_Pending] = deque()
        for p in self._queue:
            if not p.extend and now - p.t >= limit:
                self.registry.count("serve/shed_total")
                self._shed_ids.add(p.rid)
                self._drop_request(p)
            else:
                kept.append(p)
        self._queue = kept

    def _drop_request(self, p: _Pending) -> None:
        self._pages.free(p.rid)
        self._live.pop(p.rid, None)

    def submit(self, tokens, *, keep: bool = False,
               now: float | None = None) -> int:
        """Enqueue one request (1-D int32 token stream); returns its id or
        raises :class:`Shed` on overload. ``keep=True`` keeps the sequence
        resident after serving so :meth:`extend` can append tokens."""
        now = self._clock() if now is None else now
        tokens = np.asarray(tokens, np.int32).ravel()
        ln = tokens.shape[0]
        if not 1 <= ln <= self.cfg.seq_len:
            raise ValueError(
                f"request length {ln} outside [1, {self.cfg.seq_len}]"
            )
        self._evict_stale(now)
        if len(self._queue) >= self.cfg.serve_queue:
            self._shed(None, f"queue full ({self.cfg.serve_queue})")
        rid = self._next_id
        self._next_id += 1
        if self._pages.alloc(rid, ln) is None:
            self._shed(rid, "page pool exhausted")
        if keep:
            self._live[rid] = _Live(tokens=tokens.copy())
        self._queue.append(_Pending(rid, tokens, now, keep=keep))
        return rid

    def extend(self, rid: int, extra_tokens,
               now: float | None = None) -> None:
        """Append tokens to a live (``keep=True``) request and re-enqueue
        it at the front of the queue; the prefix keeps its pages."""
        now = self._clock() if now is None else now
        live = self._live.get(rid)
        if live is None:
            raise KeyError(
                f"request {rid} is not live (submit with keep=True, and "
                f"before release())"
            )
        with trace.span("extend", request=rid):
            extra = np.asarray(extra_tokens, np.int32).ravel()
            total = live.tokens.shape[0] + extra.shape[0]
            if total > self.cfg.seq_len:
                raise ValueError(
                    f"extended length {total} exceeds seq_len "
                    f"{self.cfg.seq_len}"
                )
            if self._pages.extend(rid, total) is None:
                self._shed(rid, "page pool exhausted on extend")
            live.tokens = np.concatenate([live.tokens, extra])
            self._queue.appendleft(
                _Pending(rid, live.tokens, now, keep=True, extend=True)
            )
        self.registry.count("serve/extends_total")

    def release(self, rid: int) -> None:
        """Retire a live request: pages return to the pool."""
        self._live.pop(rid)
        self._pages.free(rid)

    def drain_queue(self) -> list[tuple[int, np.ndarray]]:
        """Hand every queued (unserved) request back to the caller, freeing
        its pages (the replica hand-off path)."""
        out = []
        while self._queue:
            p = self._queue.popleft()
            out.append((p.rid, p.tokens))
            self._drop_request(p)
            self.registry.count("serve/drained_total")
        return out

    def pages_of(self, rid: int) -> list[int]:
        return self._pages.pages_of(rid)

    # -- the request loop ------------------------------------------------

    def step(self, now: float | None = None,
             force: bool = False) -> list[ServeResult]:
        """Admit queued requests and flush one micro-batch when it is due:
        batch-full, the oldest admitted request past
        ``serve_max_wait_ms``, or ``force=True``. Returns the served
        results (empty while the batch is still filling)."""
        now = self._clock() if now is None else now
        self._evict_stale(now)
        while self._queue and len(self._batch) < self.cfg.serve_max_batch:
            p = self._queue[0]
            if p.rid in self._shed_ids:
                self._queue.popleft()
                continue
            if not self._batcher.admit(p.tokens, now=p.t):
                break
            self._batch.append(p)
            self._queue.popleft()
        if not self._batch:
            return []
        full = len(self._batch) >= self.cfg.serve_max_batch
        if not (full or self._batcher.due(now) or force):
            return []
        return self._flush(now)

    def _flush(self, now: float) -> list[ServeResult]:
        n = len(self._batch)
        b = bucket_of(n, self.cfg.serve_max_batch)
        for _ in range(b - n):        # bucket padding: length-1 pad docs
            self._batcher.admit(np.zeros(1, np.int32), now=now)
        chunk = self._batcher.flush(n_rows=b)
        vals, idx, diff, prefill_ms, encode_ms = self._run_chunk(chunk, b)
        results = []
        for i, p in enumerate(self._batch):
            qw_ms = max(0.0, (now - p.t) * 1e3)
            self.registry.observe("serve/queue_wait_ms", qw_ms)
            self.registry.count("serve/requests_total")
            if not p.keep:
                self._pages.free(p.rid)
            results.append(ServeResult(
                request_id=p.rid, vals=vals[i], idx=idx[i], diff=diff[i],
                bucket=b, queue_wait_ms=qw_ms, prefill_ms=prefill_ms,
                encode_ms=encode_ms, extended=p.extend,
            ))
        trace.instant("queue_wait", docs=n,
                      max_ms=round(max(r.queue_wait_ms for r in results), 3))
        self._batch = []
        return results

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_chunk(self, chunk, b: int):
        """Prefill + encode one bucket-shaped chunk; returns host-side
        ``(vals, idx, diff)`` plus the two stage wall times."""
        cfg = self.cfg
        t0 = time.perf_counter()
        with trace.span("prefill", bucket=b):
            caps = lm.paged_capture(self._lm_params, chunk, self.lm_cfg, self._hooks,
                                    page_size=cfg.page_size)
            self._sync()
        t1 = time.perf_counter()
        with trace.span("encode", bucket=b):
            lengths = torch.as_tensor(chunk.lengths, device=self.device)
            out = serve_step.encode_topk_diff(
                self._cc_params, caps, lengths, self._norm,
                enc_dtype=cfg.enc_dtype, k=cfg.topk_k, pair=self._pair)
            vals, idx, diff = (t.cpu() for t in out)
        t2 = time.perf_counter()
        prefill_ms, encode_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        self.registry.observe("serve/prefill_ms", prefill_ms)
        self.registry.observe("serve/encode_ms", encode_ms)
        return (vals.float().numpy(), idx.numpy(), diff.float().numpy(),
                prefill_ms, encode_ms)

    def warmup(self) -> int:
        """Build the kernels (on the card) and run every bucket once on a
        full-length synthetic chunk. Returns the number of buckets run."""
        if self.device.type == "cuda":
            from crosscoder_tpu_torch.ops import _build

            _build.build_all()
        S = self.cfg.seq_len
        for b in self.buckets:
            t0 = time.perf_counter()
            chunk = pack_chunk(np.ones((b, S), np.int32),
                               np.full(b, S, np.int64), n_rows=b)
            self._run_chunk(chunk, b)
            print(f"[crosscoder_tpu_torch] serve: warm bucket={b} "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)",
                  file=sys.stderr, flush=True)
        return len(self.buckets)

    def stats(self) -> dict:
        """Registry snapshot, histogram percentiles included."""
        return dict(self.registry.snapshot())

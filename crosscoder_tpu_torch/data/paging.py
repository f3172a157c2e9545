"""Paged harvest runtime: KV page allocation + continuous batching.

A numpy-only copy of the JAX package's ``data/paging.py``: the port keeps
its own so that it imports nothing of that package.

The padded harvest (:func:`crosscoder_tpu_torch.models.lm.run_with_cache_multi`)
pads every document to ``cfg.seq_len`` and pays the full forward for every
pad token — at 50% padding efficiency that is 2x the matmul FLOPs the real
tokens need. This module is the host-side half of the ragged runtime (the
device half is :func:`crosscoder_tpu_torch.models.lm.paged_capture` and the
ragged-paged-attention kernel in
:mod:`crosscoder_tpu_torch.ops.paged_attention`), following the Ragged Paged Attention design (arXiv:2604.15464): fixed-size
KV pages + per-sequence ragged lengths, so mixed-length documents batch
without padding waste.

Three pieces, smallest first:

- :class:`PageTable` — a fixed-pool KV page allocator: pages are
  ``page_size`` tokens, a sequence owns ``ceil(len/page_size)`` of them,
  free pages live on a free-list so admission/retirement is O(pages) with
  no compaction. This is the allocator a *serving* plane shares with the
  harvest (ROADMAP item 1): the attention kernel only ever sees
  ``(page pool, page table, lengths)``, never who allocated them.
- :func:`pack_chunk` — packs one harvest chunk (``[D, seq_len]`` padded
  tokens + per-doc lengths) into a dense token *plane* ``[R, seq_len]``
  with R < D rows when documents are short: documents are placed
  back-to-back inside rows (first-fit, never wrapping a row), and the
  returned index maps let the device forward run every position-local op
  (projections, MLP, norms — ~93% of harvest FLOPs at Gemma-2-2B shapes)
  on the dense plane while attention runs per-document. All-full-length
  chunks pack to the identity layout (doc i → row i, offset 0), which is
  what makes the padded-vs-paged bit-parity gate on the production corpus
  exact rather than approximate.
- :class:`ContinuousBatcher` — the streaming scheduler: a fixed
  ``[n_rows, seq_len]`` plane of in-flight row slots; documents are
  admitted into whichever slot has room as earlier sequences retire, and
  a full plane flushes as one :class:`PackedChunk`. This is the
  continuous-batching loop a serving frontend drives; :func:`pack_chunk`
  is the same placement logic specialized to a known document set.

Everything here is host-side numpy — packing runs on the CPU alongside
the token stream, exactly like the replay buffer's cycle accounting.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "PageTable",
    "PackedChunk",
    "ContinuousBatcher",
    "pack_chunk",
    "pack_documents",
    "plane_rows",
]


def plane_rows(rows_needed: int, n_docs: int, multiple: int = 1) -> int:
    """Token-plane row count for a packing that needs ``rows_needed`` rows.

    Bucketed to a granularity of ``max(multiple, n_docs/8)`` rows so
    ragged corpora hit at most ~8 compiled plane heights per chunk shape
    (each height is one XLA program; the persistent compile cache
    amortizes them) while keeping the height within ~12% of the true
    need — a power-of-two bucket would round a half-empty plane back up
    to the padded size and erase the win. Capped at the padded row count
    (rounded to ``multiple``, the mesh data-axis divisibility): the paged
    plane never costs more rows than the layout it replaces, and an
    all-full-length chunk keeps the identity height ``n_docs``.
    """
    n_docs = max(n_docs, rows_needed, 1)
    rows_needed = max(rows_needed, 1)
    gran = max(multiple, -(-n_docs // 8), 1)
    r = -(-rows_needed // gran) * gran
    # the bucket granularity need not be a multiple of `multiple` (it may
    # be n_docs/8) — re-round so the sharded device_put never sees an
    # indivisible plane height; the cap is a multiple by construction
    r = -(-r // multiple) * multiple
    cap = -(-n_docs // multiple) * multiple
    return min(r, cap)


# ---------------------------------------------------------------------------
# page allocator


class PageTable:
    """Fixed-pool KV page allocator (pages of ``page_size`` tokens).

    The pool has ``n_pages`` pages; a sequence of ``n_tokens`` owns
    ``ceil(n_tokens/page_size)`` pages, recorded per sequence id. ``free``
    returns a retired sequence's pages to the free-list (LIFO — recently
    freed pages are hottest in cache). ``table`` materializes the
    ``[n_seqs, max_pages]`` int32 page-id array the attention kernel
    prefetches; unused slots are 0 (never read: the kernel's page loop is
    bounded by ``ceil(len/page_size)``).
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        if page_size < 1 or page_size & (page_size - 1):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}"
            )
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, seq_id: int, n_tokens: int) -> list[int] | None:
        """Pages for a new sequence; None (nothing allocated) when the pool
        can't cover it — the admission backpressure signal."""
        if seq_id in self._owned:
            raise ValueError(f"sequence {seq_id} already has pages")
        need = self.pages_needed(max(1, n_tokens))
        if need > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(need)]
        self._owned[seq_id] = pages
        return list(pages)

    def extend(self, seq_id: int, n_tokens: int) -> list[int] | None:
        """Grow a live sequence to ``n_tokens`` total (the decode path's
        page-fault); returns the newly granted pages, None on exhaustion."""
        pages = self._owned.get(seq_id)
        if pages is None:
            raise KeyError(f"unknown sequence {seq_id}")
        need = self.pages_needed(n_tokens) - len(pages)
        if need <= 0:
            return []
        if need > len(self._free):
            return None
        new = [self._free.pop() for _ in range(need)]
        pages.extend(new)
        return list(new)

    def free(self, seq_id: int) -> None:
        """Retire a sequence; its pages return to the pool."""
        for p in self._owned.pop(seq_id):
            self._free.append(p)

    def pages_of(self, seq_id: int) -> list[int]:
        return list(self._owned[seq_id])

    def table(self, seq_ids, max_pages: int | None = None) -> np.ndarray:
        """``[len(seq_ids), max_pages] int32`` page-id array, zero-padded."""
        lists = [self._owned[s] for s in seq_ids]
        if max_pages is None:
            max_pages = max((len(p) for p in lists), default=1)
        out = np.zeros((len(lists), max_pages), np.int32)
        for i, pages in enumerate(lists):
            out[i, : len(pages)] = pages
        return out


# ---------------------------------------------------------------------------
# chunk packing


@dataclass
class PackedChunk:
    """One packed token plane plus the maps the device forward needs.

    - ``tokens [R, S]``: the dense plane (unused tail positions hold
      ``pad_id``);
    - ``pos [R, S]``: within-document RoPE position of every plane slot
      (0 at unused positions);
    - ``doc_row/doc_off/lengths [D]``: where each document lives;
    - ``doc_idx [D, S]``: flat plane index (``row*S + off + t``) of each
      document token, clamped at the document's last real token for
      ``t >= len`` — the per-document gather for the attention path and
      the capture unpack;
    - ``plane_idx [R, S]``: flat ``doc*S + t`` index of the document token
      occupying each plane slot (0 for unused slots) — the scatter-back
      gather for attention outputs.
    """

    tokens: np.ndarray
    pos: np.ndarray
    doc_row: np.ndarray
    doc_off: np.ndarray
    lengths: np.ndarray
    doc_idx: np.ndarray = field(repr=False, default=None)
    plane_idx: np.ndarray = field(repr=False, default=None)

    @property
    def n_rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def n_docs(self) -> int:
        return self.lengths.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]

    def efficiency(self) -> float:
        """Real tokens / plane slots (how dense the plane actually is)."""
        return float(self.lengths.sum() / self.tokens.size)


def pack_documents(
    lengths: np.ndarray, seq_len: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """First-fit placement of documents into rows of width ``seq_len``.

    Documents never wrap a row (a document is at most ``seq_len`` tokens —
    enforced by the caller — so per-document attention buffers stay
    ``[seq_len]``-shaped). Returns ``(row, off, rows_used)``. First-fit in
    arrival order keeps the layout streaming-compatible (the
    ContinuousBatcher produces the identical placement) and maps
    all-full-length chunks to the identity layout.
    """
    lengths = np.asarray(lengths, np.int64)
    if lengths.size and int(lengths.max()) > seq_len:
        raise ValueError(
            f"document of {int(lengths.max())} tokens exceeds seq_len {seq_len}"
        )
    if lengths.size and int(lengths.min()) < 1:
        raise ValueError("document lengths must be >= 1")
    row = np.zeros(lengths.size, np.int32)
    off = np.zeros(lengths.size, np.int32)
    cursors: list[int] = []
    for d, ln in enumerate(lengths):
        for r, used in enumerate(cursors):
            if used + ln <= seq_len:
                row[d], off[d] = r, used
                cursors[r] += int(ln)
                break
        else:
            row[d], off[d] = len(cursors), 0
            cursors.append(int(ln))
    return row, off, len(cursors)


def pack_chunk(
    tokens: np.ndarray,
    lengths: np.ndarray,
    *,
    n_rows: int | None = None,
    row_multiple: int = 1,
    pad_id: int = 0,
) -> PackedChunk:
    """Pack a padded-layout chunk ``[D, S]`` + lengths into a dense plane.

    ``n_rows`` pins the plane height (compile-shape control); default is
    :func:`plane_rows` bucketing. The plane is filled with ``pad_id``
    at unused positions, whose forward values are finite and never
    gathered into any document's output.
    """
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths, np.int64)
    D, S = tokens.shape
    if lengths.shape != (D,):
        raise ValueError(f"lengths must be [{D}], got {lengths.shape}")
    row, off, used = pack_documents(lengths, S)
    if n_rows is None:
        n_rows = plane_rows(used, D, row_multiple)
    elif n_rows < used:
        raise ValueError(f"n_rows {n_rows} < rows needed {used}")

    plane = np.full((n_rows, S), pad_id, tokens.dtype)
    pos = np.zeros((n_rows, S), np.int32)
    plane_idx = np.zeros((n_rows, S), np.int64)
    doc_idx = np.zeros((D, S), np.int64)
    t_full = np.arange(S)
    for d in range(D):
        ln, r, o = int(lengths[d]), int(row[d]), int(off[d])
        plane[r, o: o + ln] = tokens[d, :ln]
        pos[r, o: o + ln] = t_full[:ln]
        plane_idx[r, o: o + ln] = d * S + t_full[:ln]
        # clamp t >= len at the last real token: those gathers are masked
        # by the attention length mask and zeroed at unpack, but must not
        # read out of the plane
        src = o + np.minimum(t_full, ln - 1)
        doc_idx[d] = r * S + src
    return PackedChunk(
        tokens=plane, pos=pos,
        doc_row=row, doc_off=off, lengths=lengths.astype(np.int32),
        doc_idx=doc_idx.astype(np.int32), plane_idx=plane_idx.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# continuous batching


class ContinuousBatcher:
    """Streaming admission into a fixed ``[n_rows, seq_len]`` plane.

    The serving-shaped loop: ``admit`` places a document into the first
    in-flight row slot with room (allocating its KV pages when a
    :class:`PageTable` is attached) and returns False when nothing fits —
    the caller then ``flush``es the plane (one device dispatch), which
    retires every admitted sequence (pages freed) and opens all slots
    again. Admission order is preserved, so a flushed plane is exactly
    :func:`pack_chunk` of the admitted documents.
    """

    def __init__(
        self, seq_len: int, n_rows: int, page_table: PageTable | None = None,
        pad_id: int = 0, max_wait_s: float | None = None,
    ) -> None:
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1, got {n_rows}")
        if max_wait_s is not None and max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.seq_len = seq_len
        self.n_rows = n_rows
        self.page_table = page_table
        self.pad_id = pad_id
        self.max_wait_s = max_wait_s
        self._docs: list[np.ndarray] = []
        self._admitted_at: list[float] = []
        self._cursors = [0] * n_rows
        self._next_seq = 0

    @property
    def n_admitted(self) -> int:
        return len(self._docs)

    def admit(self, doc: np.ndarray, now: float | None = None) -> bool:
        """Place one document (1-D token array); False = no slot has room
        (or the page pool is exhausted) — flush first. ``now`` stamps the
        admission for the slot deadline (:meth:`due`); defaults to 0.0 so
        callers without a deadline pay nothing."""
        doc = np.asarray(doc)
        ln = doc.shape[0]
        if not 1 <= ln <= self.seq_len:
            raise ValueError(
                f"document length {ln} outside [1, {self.seq_len}]"
            )
        for r in range(self.n_rows):
            if self._cursors[r] + ln <= self.seq_len:
                if self.page_table is not None:
                    if self.page_table.alloc(self._next_seq, ln) is None:
                        return False
                self._cursors[r] += ln
                self._docs.append(doc)
                self._admitted_at.append(0.0 if now is None else now)
                self._next_seq += 1
                return True
        return False

    def oldest_wait(self, now: float) -> float:
        """Seconds the OLDEST admitted document has been waiting (0.0 when
        the plane is empty) — the deadline-aware micro-batching signal."""
        if not self._admitted_at:
            return 0.0
        return now - self._admitted_at[0]

    def due(self, now: float) -> bool:
        """True when the oldest admitted document has waited past
        ``max_wait_s``: the plane must flush even though it is not full —
        the slot-deadline half of continuous batching (a partial plane is
        latency bounded; an unbounded wait for batch-full is not)."""
        if self.max_wait_s is None or not self._docs:
            return False
        return self.oldest_wait(now) >= self.max_wait_s

    def flush(self, n_rows: int | None = None) -> PackedChunk | None:
        """Close the plane: retire every sequence and return the packed
        chunk (None when nothing was admitted). ``n_rows`` overrides the
        plane height for this flush (compile-shape control for bucketed
        serving; must cover the admitted placement)."""
        if not self._docs:
            return None
        D = len(self._docs)
        lengths = np.asarray([d.shape[0] for d in self._docs], np.int64)
        tokens = np.full((D, self.seq_len), self.pad_id,
                         self._docs[0].dtype)
        for i, doc in enumerate(self._docs):
            tokens[i, : doc.shape[0]] = doc
        if self.page_table is not None:
            for s in range(self._next_seq - D, self._next_seq):
                self.page_table.free(s)
        chunk = pack_chunk(tokens, lengths,
                           n_rows=self.n_rows if n_rows is None else n_rows,
                           pad_id=self.pad_id)
        self._docs = []
        self._admitted_at = []
        self._cursors = [0] * self.n_rows
        return chunk

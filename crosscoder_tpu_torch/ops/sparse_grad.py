"""Sorted-pair scatter-accumulate, ported from
:mod:`crosscoder_tpu.ops.sparse_grad`: the one primitive behind every
gradient of the sparse backward plane,

    out[idx[b, j]] += coeff[b, j] * rows[b]        (B·k pairs, f32 sums)

:func:`scatter_add_rows` sorts the pairs by destination (stable, so
duplicate destinations keep their batch-major order; out-of-range
destinations get the sentinel ``n_out`` and sort last, dropped), as the
JAX package does outside its kernel, and cuts the sorted list into a work
list (:func:`work_list`, on the card with no host sync; the plain
:func:`work_list_plain` on the CPU). Then:

- on CUDA tensors it launches K10, ``csrc/scatter_rows.cu``: a block per
  (work item, 512-column slice) walks the item's pairs in sorted order and
  writes every element of the item's rows once, no atomics;
- on CPU tensors it runs :func:`scatter_add_rows_plain`, which adds in the
  same order: for rank r = 0, 1, … within each destination group,
  ``out[dst_r] = out[dst_r] + cf_r * rows[src_r]`` (each destination
  appears at most once per rank). ``index_add_`` is not that order on the
  card (atomics), so it is no plain version here.

Both are bitwise equal on the same inputs. :func:`supported` and
:func:`decode_grad_supported` mirror the JAX package's gates of the same
names, which decide the sparse tiers (``models/crosscoder.use_sparse_aux``);
they are not limits of the Hopper kernel.
"""

from __future__ import annotations

import ctypes

import torch

# K10's work list: a cold item holds at most _RB destination rows and
# fewer than 2·_T pairs; a destination with more than _T pairs is hot and
# is an item of its own
_RB = 32
_T = 256
_LIST_TILE = 1024       # rows a block of the list's counting pass (kListThreads)

# --- the JAX package's dispatch gates (crosscoder_tpu/ops/sparse_grad.py) ---
_VMEM_BUDGET_BYTES = 13 << 20
_ROW_BLOCK = 256
_MAX_PAIRS = 1 << 18


def _row_block(n_out: int) -> int:
    rb = min(_ROW_BLOCK, n_out)
    rb -= rb % 8
    while rb >= 8 and n_out % rb:
        rb -= 8
    return rb if rb >= 8 else 0


def _pad_pairs(n_pairs: int) -> int:
    return -(-max(n_pairs, 1) // 128) * 128


def _m_chunk(m: int, n_rows: int, itemsize: int, rb: int, n_pairs: int) -> int:
    pair_bytes = 12 * _pad_pairs(n_pairs)
    mc = min(m, 2048)
    mc -= mc % 128
    while mc >= 128:
        if m % mc == 0 and n_rows * mc * itemsize + rb * mc * 4 + pair_bytes <= _VMEM_BUDGET_BYTES:
            return mc
        mc -= 128
    return 0


def supported(n_out: int, m: int, n_rows: int, n_pairs: int) -> bool:
    """The JAX package's ``sparse_grad.supported``: whether its TPU kernel
    takes these shapes."""
    if m < 128 or m % 128 or n_out < 8 or n_pairs < 1 or n_pairs > _MAX_PAIRS:
        return False
    rb = _row_block(n_out)
    return bool(rb) and _m_chunk(m, n_rows, 4, rb, n_pairs) > 0


def decode_grad_supported(dict_size: int, k: int, n_sources: int, d_in: int,
                          batch: int) -> bool:
    """The JAX package's ``sparse_grad.decode_grad_supported``: both
    scatter calls of the sparse step (``m = n·d`` and the bias-augmented
    ``m = n·d + 128``) supported."""
    m = n_sources * d_in
    return (supported(dict_size, m, batch, batch * k)
            and supported(dict_size, m + 128, batch, batch * k))


def sorted_pairs(coeff: torch.Tensor, idx: torch.Tensor, n_out: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dst, src, cf)`` of the B·k pairs, stably sorted by destination
    (int32 keys, the kernel's index type); an out-of-range destination
    becomes the sentinel ``n_out``."""
    B, k = coeff.shape
    dst = idx.reshape(-1).to(torch.int64)
    dst = torch.where((dst >= 0) & (dst < n_out), dst, n_out).to(torch.int32)
    dst_s, order = torch.sort(dst, stable=True)
    src_s = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    cf_s = coeff.reshape(-1).to(torch.float32)[order]
    return dst_s, src_s, cf_s


def _check(coeff, idx, rows):
    if coeff.shape != idx.shape or coeff.dim() != 2 or rows.dim() != 2:
        raise ValueError(f"scatter_add_rows wants coeff/idx [B, k] and rows [B, m], got "
                         f"{tuple(coeff.shape)}/{tuple(idx.shape)}/{tuple(rows.shape)}")
    if coeff.shape[0] != rows.shape[0]:
        raise ValueError(f"coeff batch {coeff.shape[0]} != rows batch {rows.shape[0]}")


def scatter_add_rows_plain(coeff: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                           n_out: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`scatter_add_rows`."""
    _check(coeff, idx, rows)
    dst_s, src_s, cf_s = sorted_pairs(coeff, idx, n_out)
    keep = dst_s < n_out
    dst_s, src_s, cf_s = dst_s[keep], src_s[keep], cf_s[keep]
    out = torch.zeros((n_out, rows.shape[1]), dtype=torch.float32, device=rows.device)
    if dst_s.numel() == 0:
        return out
    first = torch.searchsorted(dst_s, dst_s, side="left")
    rank = torch.arange(dst_s.numel(), device=rows.device) - first
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        d = dst_s[sel]
        out[d] = out[d] + cf_s[sel][:, None] * rows[src_s[sel]].float()
    return out


def work_list_bound(n_out: int, n_pairs: int) -> int:
    """The most items :func:`work_list` can make for ``n_pairs`` sorted
    pairs onto ``n_out`` rows: a cut at every ``_RB``-th row, at every hot
    row (at most ``n_pairs // (_T + 1)`` of them), and wherever the running
    pair count crosses a multiple of ``_T`` (which it does after every hot
    row)."""
    return -(-n_out // _RB) + n_pairs // (_T + 1) + n_pairs // _T


def work_list_plain(dst_s: torch.Tensor, n_out: int) -> torch.Tensor:
    """K10's work items, int32 ``[work_list_bound(n_out, P), 4]``, one row
    ``(r0, r1, s, e)`` each: the item writes output rows ``[r0, r1)``, and
    ``[s, e)`` are exactly those rows' pairs in ``dst_s`` (sorted, with
    sentinels ``n_out`` last). Rows are cut into runs at every ``_RB``-th
    row, at every hot row (more than ``_T`` pairs) and where the pairs
    before a row cross a multiple of ``_T`` (so after every hot row): every
    row lies in exactly one item, a hot row alone, a cold item under
    ``2·_T`` pairs. Hot items come
    first, then cold ones, each in row order; the unused tail is empty
    (``r0 == r1 == n_out``). The plain PyTorch version of
    :func:`work_list`."""
    dev = dst_s.device
    n_items = work_list_bound(n_out, dst_s.numel())
    rows = torch.arange(n_out, device=dev)
    rs = torch.searchsorted(dst_s, torch.arange(n_out + 1, device=dev), side="left")
    hot = rs[1:] - rs[:-1] > _T
    bucket = rs[:-1] // _T
    cut = (rows % _RB == 0) | hot
    cut[1:] |= bucket[1:] != bucket[:-1]
    # in row order, the j-th cut row starts item j, which ends at the next cut
    first = torch.full((n_items + 1,), n_out, dtype=torch.int64, device=dev)
    first.scatter_(0, torch.where(cut, torch.cumsum(cut, 0) - 1, n_items), rows)
    first[n_items] = n_out                      # the slot every other row wrote
    r0, r1 = first[:-1], first[1:]
    real = r0 < n_out
    is_hot = real & hot[r0.clamp(max=n_out - 1)]
    is_cold = real & ~is_hot
    slot = torch.where(is_hot, torch.cumsum(is_hot, 0) - 1,
                       torch.where(is_cold, is_hot.sum() + torch.cumsum(is_cold, 0) - 1,
                                   torch.arange(n_items, device=dev)))
    items = torch.empty((n_items, 4), dtype=torch.int64, device=dev)
    items[slot] = torch.stack([r0, r1, rs[r0], rs[r1]], dim=1)
    return items.to(torch.int32)


PROTOTYPES = {
    "scatter_work_list": ([ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                          + [ctypes.c_int, ctypes.c_void_p]),
    "scatter_rows_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
}


def work_list(dst_s: torch.Tensor, n_out: int) -> torch.Tensor:
    """K10's work list of the sorted destinations ``dst_s``
    (:func:`work_list_plain`): built on the card by three launches of
    ``csrc/scatter_rows.cu`` (a binary search for each row's first pair;
    each tile of rows counts its items; each tile places its items after
    those of the tiles before it) with no host sync; the plain version on
    CPU tensors."""
    if dst_s.device.type == "cpu":
        return work_list_plain(dst_s, n_out)
    from crosscoder_tpu_torch.ops import _build

    dst32 = dst_s.to(torch.int32).contiguous()          # a no-op on sorted_pairs' keys
    n_items = work_list_bound(n_out, dst32.numel())
    # the n_out + 1 row starts (int32), then a count for each tile of rows
    scratch = torch.empty((n_out + 2) // 2 + -(-n_out // _LIST_TILE), dtype=torch.int64,
                          device=dst32.device)
    items = torch.empty((n_items, 4), dtype=torch.int32, device=dst32.device)
    code = _build.load("scatter_rows", PROTOTYPES).scatter_work_list(
        dst32.data_ptr(), dst32.numel(), n_out, _T, _RB, scratch.data_ptr(), items.data_ptr(),
        n_items, _build.stream(dst32.device))
    _build.check(code, "scatter work list kernel")
    return items


def scatter_add_rows(coeff: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                     n_out: int) -> torch.Tensor:
    """``out [n_out, m] f32`` with ``out[idx[b, j]] += coeff[b, j] * rows[b]``.

    ``coeff/idx: [B, k]``, ``rows: [B, m]`` (f32 or bf16; sums in f32).
    Out-of-range indices are dropped. The plain version on CPU tensors, K10
    on CUDA tensors (or :class:`ValueError`)."""
    if rows.device.type == "cpu":
        return scatter_add_rows_plain(coeff, idx, rows, n_out)
    if rows.device.type != "cuda":
        raise ValueError(f"scatter_add_rows runs on cpu or cuda, got {rows.device}")
    from crosscoder_tpu_torch.ops import _build

    _check(coeff, idx, rows)
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"scatter kernel takes f32 or bf16 rows, got {rows.dtype}")
    if n_out < 1 or coeff.numel() >= 2 ** 31:
        raise ValueError(f"scatter kernel takes n_out >= 1 and < 2^31 pairs, got "
                         f"{n_out}, {coeff.numel()}")
    rows = rows.contiguous()
    m = rows.shape[1]
    dst_s, src_s, cf_s = sorted_pairs(coeff, idx, n_out)
    items = work_list(dst_s, n_out)
    out = torch.empty((n_out, m), dtype=torch.float32, device=rows.device)
    # 16-byte copies of 4 f32 (8 of 4 bf16) a thread when every row starts aligned
    vec = int(m % 4 == 0 and rows.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    code = _build.load("scatter_rows", PROTOTYPES).scatter_rows_launch(
        items.data_ptr(), dst_s.data_ptr(), src_s.data_ptr(), cf_s.data_ptr(), rows.data_ptr(),
        out.data_ptr(), items.shape[0], m, int(rows.dtype == torch.bfloat16), vec,
        _build.stream(rows.device))
    _build.check(code, "scatter rows kernel")
    _scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0
# the wrapper counts on itself through this name, so the count stays the
# wrapper's where something else is bound to the module's name
_scatter_add_rows = scatter_add_rows

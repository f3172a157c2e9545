"""Sorted-pair scatter-accumulate, ported from
:mod:`crosscoder_tpu.ops.sparse_grad`: the one primitive behind every
gradient of the sparse backward plane,

    out[idx[b, j]] += coeff[b, j] * rows[b]        (B·k pairs, f32 sums)

:func:`scatter_add_rows` sorts the pairs by destination (stable, so
duplicate destinations keep their batch-major order; out-of-range
destinations get the sentinel ``n_out`` and sort last, dropped) and cuts
the sorted list into per-row-block ranges with a searchsorted, in PyTorch,
as the JAX package does outside its kernel. Then:

- on CUDA tensors it launches K10, ``csrc/scatter_rows.cu``: a block per
  output tile walks its range in sorted order and writes every element of
  the tile once, no atomics;
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

_RB = 32                      # destination rows per K10 block

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
    """``(dst, src, cf)`` of the B·k pairs, stably sorted by destination;
    an out-of-range destination becomes the sentinel ``n_out``."""
    B, k = coeff.shape
    dst = idx.reshape(-1).to(torch.int64)
    dst = torch.where((dst >= 0) & (dst < n_out), dst, n_out)
    dst_s, order = torch.sort(dst, stable=True)
    src_s = torch.div(order, k, rounding_mode="floor")
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
    n_blocks = -(-n_out // _RB)
    bounds = torch.clamp(torch.arange(n_blocks + 1, device=rows.device) * _RB, max=n_out)
    starts = torch.searchsorted(dst_s, bounds, side="left").to(torch.int32)
    dst32 = dst_s.to(torch.int32)
    src32 = src_s.to(torch.int32)
    out = torch.empty((n_out, m), dtype=torch.float32, device=rows.device)
    fn = _build.load("scatter_rows").scatter_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    code = fn(dst32.data_ptr(), src32.data_ptr(), cf_s.data_ptr(), starts.data_ptr(),
              rows.data_ptr(), out.data_ptr(), n_out, m, _RB, int(rows.dtype == torch.bfloat16),
              torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(code, "scatter rows kernel")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0

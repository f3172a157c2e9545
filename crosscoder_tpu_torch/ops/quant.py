"""Block-scaled symmetric int8 quantization, ported from
:mod:`crosscoder_tpu.ops.quant`.

Values quantize per contiguous block of ``block`` elements along the last
axis:

    scale[..., b] = max(|x[..., b*B:(b+1)*B]|) * fl(1/127)
    q[..., j]     = clip(round(x[..., j] / scale), -127, 127)  int8

(round half to even; an all-zero block gets scale 0 and quantizes to
zeros; a NaN quotient stores 0). The scale is the product with the f32
reciprocal of 127, not a division by 127: that is what the JAX package
computes wherever it runs compiled (XLA strength-reduces the division by
the constant in the jitted ``quantize_blocks``, the buffer's quantize jits
and the Pallas kernel), so the port's int8 stores hold the JAX buffer's
bytes. The JAX package's eager ``quantize_blocks`` and numpy
``quantize_np`` divide, and differ from it in the scale's last bit on a
few percent of blocks (ROADMAP C3). A ``[..., d]`` tensor stores as int8
``[..., d]`` plus f32 scales ``[..., d / B]``, ``(1 + 4/B)/2`` of its bf16
bytes. The replay buffer's int8 stores (``cfg.quant_buffer``) keep rows
this way.

- :func:`quantize_blocks` / :func:`dequantize_blocks`: PyTorch, any device.
  The element division takes a tensor divisor, never a Python scalar, so
  no backend turns it into a reciprocal multiply.
- :func:`quantize_np` / :func:`dequantize_np`: the JAX package's numpy
  forms as it has them, for analysis and tests; the port's stores never
  call them. ``quantize_np`` divides ``amax`` by 127 as the JAX one does,
  so its scale may differ from :func:`quantize_blocks`' in the last bit.
- :func:`quantize_rows`: on CUDA tensors the K11 kernel
  ``csrc/quantize_rows.cu`` (one pass: block max, scale, round), bitwise
  :func:`quantize_blocks`; contiguous rows take its row route, a
  transposed view (``W2.t()``) its column route, which reads the view's
  storage in place (:func:`quantize_route`); on CPU tensors
  :func:`quantize_blocks` itself.
- :func:`quantize_contraction`: both operands of ``x2 · W2`` block-scaled
  along the contraction axis, for the int8 fused encoder (K3).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

QMAX = 127.0
_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))     # fl(1/127), exact in f32


def n_blocks(d: int, block: int) -> int:
    if block <= 0 or d % block:
        raise ValueError(
            f"quant block {block} must be a positive divisor of the "
            f"quantized axis length {d}"
        )
    return d // block


def quantize_blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [..., d]`` (any float dtype) → ``(q int8 [..., d], scales f32
    [..., d/block])``: the plain version of :func:`quantize_rows`."""
    nb = n_blocks(x.shape[-1], block)
    xb = x.float().reshape(*x.shape[:-1], nb, block)
    amax = xb.abs().amax(dim=-1)                                # NaN propagates
    scale = amax * torch.full_like(amax, _INV_QMAX)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xb / safe[..., None]), -QMAX, QMAX)
    q = torch.nan_to_num(q, nan=0.0)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: ``q [..., d]`` int8 + scales
    ``[..., d/block]`` → values ``[..., d]`` in ``dtype``."""
    nb = scales.shape[-1]
    block = q.shape[-1] // nb
    qb = q.float().reshape(*q.shape[:-1], nb, block)
    return (qb * scales.float()[..., None]).reshape(q.shape).to(dtype)


def dequantize_np(q: np.ndarray, scales: np.ndarray, dtype) -> np.ndarray:
    """NumPy :func:`dequantize_blocks` (bitwise the same)."""
    nb = scales.shape[-1]
    block = q.shape[-1] // nb
    qb = q.astype(np.float32).reshape(*q.shape[:-1], nb, block)
    out = qb * scales.astype(np.float32)[..., None]
    return out.reshape(q.shape).astype(dtype)


def quantize_np(x: np.ndarray, block: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's numpy ``quantize_np``: round half to even, and the
    scale ``amax / 127`` by division, not the reciprocal product of
    :func:`quantize_blocks` (ROADMAP C3)."""
    nb = n_blocks(x.shape[-1], block)
    xb = x.astype(np.float32).reshape(*x.shape[:-1], nb, block)
    amax = np.max(np.abs(xb), axis=-1)
    scale = (amax / QMAX).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.round(xb / safe[..., None]), -QMAX, QMAX)
    return q.astype(np.int8).reshape(x.shape), scale


_PROTOTYPES = {
    "quantize_rows_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                             + [ctypes.c_void_p]),
    "quantize_cols_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                             + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}


def quantize_route(x: torch.Tensor) -> str:
    """The K11 route for ``x``: ``"column"`` for a 2-D transposed view (its
    rows strided, its first axis contiguous, as ``W2.t()`` is), quantized
    where it lies; ``"row"`` for anything else, whose rows are made
    contiguous first (no copy when they already are)."""
    if (x.dim() == 2 and not x.is_contiguous() and x.stride(0) == 1
            and x.stride(1) >= x.shape[0]):
        return "column"
    return "row"


def quantize_rows(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``[..., d]`` rows: :func:`quantize_blocks` on CPU tensors,
    the K11 kernel on CUDA tensors (bf16 or f32, ``block`` a multiple of 8
    dividing ``d``; else :class:`ValueError`), by the route
    :func:`quantize_route` picks before anything launches. Bitwise equal
    either way. Counts its launches on ``quantize_rows.launches`` and by
    route on ``quantize_rows.by_route``."""
    if x.device.type == "cpu":
        return quantize_blocks(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows runs on cpu or cuda, got {x.device}")
    from crosscoder_tpu_torch.ops import _build

    d = x.shape[-1]
    nb = n_blocks(d, block)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize kernel takes bf16 or f32 rows, got {x.dtype}")
    if block % 8:
        raise ValueError(f"quantize kernel takes blocks that are a multiple of 8, got {block}")
    lib = _build.load("quantize_rows", _PROTOTYPES)
    bf16 = int(x.dtype == torch.bfloat16)
    route = quantize_route(x)
    if route == "column":
        R, ld = x.shape[0], x.stride(1)
        q = torch.empty((R, d), dtype=torch.int8, device=x.device)
        s = torch.empty((R, nb), dtype=torch.float32, device=x.device)
        vec = int(x.data_ptr() % 16 == 0 and ld * x.element_size() % 16 == 0)
        code = lib.quantize_cols_launch(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, d, ld, block,
                                        bf16, vec, _build.stream(x.device))
    else:
        flat = x.reshape(-1, d)
        if not flat.is_contiguous():
            flat = flat.contiguous()
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        s = torch.empty((*x.shape[:-1], nb), dtype=torch.float32, device=x.device)
        code = lib.quantize_rows_launch(flat.data_ptr(), q.data_ptr(), s.data_ptr(),
                                        flat.shape[0] * nb, block, bf16,
                                        int(flat.data_ptr() % 16 == 0), _build.stream(x.device))
    _build.check(code, f"quantize rows kernel ({route} route)")
    quantize_rows.launches += 1
    quantize_rows.by_route[route] += 1
    return q, s


quantize_rows.launches = 0
quantize_rows.by_route = {"row": 0, "column": 0}   # launches of each route


def quantize_contraction(x2: torch.Tensor, W2: torch.Tensor, block: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-scaled int8 operands of ``x2 [B, nd] · W2 [nd, H]`` along the
    contraction axis (the JAX ``_quantize_contraction``): ``x2`` per (row,
    block), ``W2`` per (block, column), i.e. ``quantize_blocks(W2.T)``
    transposed back. Returns ``(xq int8 [B, nd], xs f32 [B, nb], wq int8
    [nd, H], ws f32 [nb, H])``; ``wq`` and ``ws`` are transposed views of
    the ``[H, nd]`` / ``[H, nb]`` quantization. Through :func:`quantize_rows`:
    the compiled JAX form of the scale on any device, K11 on the card,
    where ``W2.t()`` takes its column route (``W2`` read in place, no
    transposed copy)."""
    xq, xs = quantize_rows(x2, block)
    wqT, wsT = quantize_rows(W2.t(), block)
    return xq, xs, wqT.t(), wsT.t()


def store_bytes(shape: tuple[int, ...], block: int) -> int:
    """Bytes of an int8 store of this logical shape: the int8 payload plus
    the f32 per-block scales."""
    n = int(np.prod(shape))
    return n + 4 * (n // block)

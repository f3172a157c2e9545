"""Exact per-row TopK masks and the sparsify drain, ported from
:mod:`crosscoder_tpu.ops.topk_pallas`.

- :func:`topk` (``h [..., width]`` → the top-k of ``relu(h)`` per row,
  zeros elsewhere; ties to the lowest index) is a
  :class:`torch.autograd.Function` whose backward is the straight-through
  mask ``where(out > 0, g, 0)``. :func:`topk_forward` dispatches as the
  JAX package's ``_topk_fwd_impl`` (:func:`topk_route`): bf16 rows up to
  2^16 wide to K5 (:func:`topk_mask`, ``csrc/topk_mask.cu``), f32 rows
  that pass the JAX single-block gate to K6 (:func:`topk_mask_f32`,
  ``csrc/topk_mask_f32.cu``), every other bf16 or f32 row to K7
  (:func:`topk_chunked`, ``csrc/topk_chunked.cu``, any width). K5 and K7's
  cluster route share ``csrc/topk_slice.cuh``: a row held in the shared
  memory of one block (K5) or of a thread-block cluster's blocks, a slice
  each (K7, as :func:`topk_plan` cuts it; :func:`topk_sliced_plain` models
  it); rows too wide for a cluster take K7's streaming route.
- :func:`sparsify` (``f [..., width]`` with at most k positives a row →
  ``(vals [..., k], idx [..., k] int32)``, ascending index,
  ``(0, 0)``-padded; a row past k overwrites slot k-1) launches K8,
  ``csrc/sparsify.cu``, on CUDA tensors, bf16 or f32: a row split over
  2, 4 or 8 warps, or a warp a row, as :func:`sparsify_plan` picks
  (:func:`sparsify_split_plain` models the split).
- :func:`batchtopk` (every ReLU'd entry at or above the ``min(k·rows,
  numel)``-th largest of the whole batch, all ties kept) and
  :func:`batchtopk_fixed` (its eval mode, a fixed threshold) are
  :class:`torch.autograd.Function`s with the straight-through backward
  ``where(out > 0, g, 0)`` over K9, ``csrc/batchtopk.cu``: the select
  kernel (:func:`batchtopk_select`, the threshold as a device int32) and
  the emit kernel (:func:`batchtopk_emit`), bf16 or f32. Entries rank by
  clamped bit patterns, K5's rule: sign-set patterns are 0, a NaN ranks
  above +inf.

Each kernel has a plain PyTorch version (:func:`topk_plain` for K5 and
K6, :func:`topk_chunked_plain`, :func:`sparsify_plain`,
:func:`batchtopk_select_plain`, :func:`batchtopk_emit_plain`) with the
same bits as the kernel; the wrappers use it for CPU tensors only.
:func:`supported` and :func:`sparsify_supported` mirror the JAX package's
dispatch gates of the same names, which decide the crosscoder's TopK
tiers; they are not limits of the Hopper kernels.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_MAX_WIDTH = 1 << 16          # K5: bf16 rows up to 2^16 wide (composite-key domain)
_K6_MAX_WIDTH = 48 * 1024     # K6: an f32 row staged in shared memory (192 KB)
_SLICE_BYTES = 64 * 1024      # K7's cluster route: a row slice a block, so three blocks fit an SM
_MAX_CLUSTER = 8              # the portable thread-block cluster size (csrc/topk_slice.cuh)
_NO_CLUSTER = -1              # launch code of csrc/topk_slice.cuh: no such cluster fits an SM

# --- the JAX package's dispatch gates (crosscoder_tpu/ops/topk_pallas.py) ---
_VMEM_BUDGET_BYTES = 13 << 20
_MIN_ROWS = 32
_CHUNK_WIDTH = 4096
_SPARSIFY_CW = 2048


def supported(width: int, k: int, dtype: torch.dtype) -> bool:
    """The JAX package's ``topk_pallas.supported`` for rows of this width
    and dtype: whether a TPU kernel takes them (else it runs the dense
    path, which computes the same mask)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return (_composite_supported(width, k, dtype) or _single_block_supported(width, k, itemsize)
            or _chunked_supported(width, k))


def _composite_supported(width: int, k: int, dtype: torch.dtype) -> bool:
    return (dtype == torch.bfloat16 and width % 128 == 0 and 256 <= width <= _MAX_WIDTH
            and 0 < k < width)


def _single_block_supported(width: int, k: int, itemsize: int) -> bool:
    return (width % 128 == 0 and width >= 256 and 0 < k < width
            and _MIN_ROWS * width * (2 * itemsize + 8) <= _VMEM_BUDGET_BYTES)


def _chunked_supported(width: int, k: int) -> bool:
    return width % _CHUNK_WIDTH == 0 and width // _CHUNK_WIDTH >= 2 and 0 < k < width


def sparsify_supported(width: int, k: int) -> bool:
    """The JAX package's ``topk_pallas.sparsify_supported``."""
    return 0 < k <= 128 and (width % _SPARSIFY_CW == 0 or width <= 8192)


# ---------------------------------------------------------------------------
# K5, K6, K7: TopK masks


def _keys(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(key, value)``: the int32 selection key of each entry (-1: never
    kept) and the value written where it is kept. bf16 rows use the TPU
    composite kernel's clamped 15-bit patterns (every NaN as 0x7FFE above
    +inf, sign-set patterns as 0, the value rebuilt from the pattern); f32
    rows the bit patterns of ``max(h, 0)`` with NaN kept (negative NaN and
    -0.0 never kept)."""
    if h.dtype == torch.bfloat16:
        p = h.view(torch.int16).to(torch.int32) & 0xFFFF
        neg = torch.where(p > 0xFF80, 0x7FFE, 0)
        p = torch.where(p >= 0x8000, neg, torch.clamp(p, max=0x7FFE))
        return p, p.to(torch.int16).view(torch.bfloat16)
    hp = torch.where(torch.isnan(h) | (h > 0), h, torch.zeros((), dtype=h.dtype, device=h.device))
    bits = hp.view(torch.int32)
    return torch.where(bits < 0, -1, bits), hp


# K7's bit-pattern range: the JAX chunked kernel bisects over [0, top) with
# count(pattern >= top) taken as 0 (`_shift_and_range`). bf16 keys are
# clamped below it; f32 NaN keys lie above +inf's pattern 0x7F800000.
_CHUNKED_TOP = {torch.bfloat16: 1 << 15, torch.float32: 0x7F800001}


def _mask_plain(h: torch.Tensor, k: int, top: int | None) -> torch.Tensor:
    """Keep every key above ``kth`` and the lowest-column ``k - count(>
    kth)`` keys equal to it, where ``kth`` is the k-th largest key clamped
    below ``top`` (0 when fewer than k keys are non-negative) and
    ``count(> kth)`` is taken as 0 when ``kth + 1 == top``."""
    width = h.shape[-1]
    flat = h.reshape(-1, width)
    key, value = _keys(flat)
    kc = key if top is None else torch.clamp(key, max=top - 1)
    kth = torch.topk(kc, k, dim=1).values[:, k - 1:].clamp(min=0)      # [R, 1]
    n_gt = (kc > kth).sum(dim=1, keepdim=True)
    if top is not None:
        n_gt = torch.where(kth == top - 1, 0, n_gt)
    del kc
    eq = key == kth
    keep = (key > kth) | (eq & (torch.cumsum(eq, dim=1, dtype=torch.int32) <= k - n_gt))
    out = torch.where(keep, value, torch.zeros((), dtype=h.dtype, device=h.device))
    return out.reshape(h.shape)


def topk_plain(h: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version of K5 (bf16) and K6 (f32): the exact
    top-k by (key desc, column asc), as the TPU kernels bisect for the k-th
    largest key and keep the lowest-column ties."""
    return _mask_plain(h, k, None)


def topk_chunked_plain(h: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version of K7, the JAX width-chunked kernels'
    function: :func:`topk_plain`'s with keys clamped below the bisection's
    range ``top``. For bf16 this is :func:`topk_plain`'s mask. For f32 it
    differs where NaN keys (above +inf) sit among a row's top k: K7 then
    keeps every NaN and up to k entries at +inf (ROADMAP C6)."""
    return _mask_plain(h, k, _CHUNKED_TOP[h.dtype])


def _slice_cols(width: int, n_slices: int) -> int:
    """Columns of each of ``n_slices`` slices of a row (a multiple of 8,
    so each slice starts 16-byte aligned; the last may be shorter or
    empty)."""
    return (-(-width // n_slices) + 7) // 8 * 8


def topk_plan(width: int, dtype: torch.dtype) -> tuple[str, int, int]:
    """How K7 launches on rows of this width: ``("cluster", C, S)``, a
    thread-block cluster of ``C`` blocks a row, each holding ``S`` columns
    in shared memory, for rows that fit ``_MAX_CLUSTER`` slices of at most
    ``_SLICE_BYTES``; else ``("streaming", 0, 0)``, the kernel that reads
    the row from device memory once a pass."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    n = max(1, -(-width * itemsize // _SLICE_BYTES))
    if n > _MAX_CLUSTER:
        return "streaming", 0, 0
    return "cluster", n, _slice_cols(width, n)


def topk_sliced_plain(h: torch.Tensor, k: int, n_slices: int, top: int | None) -> torch.Tensor:
    """A plain model of K7's cluster route (K5 at one slice): the row cut
    into ``n_slices`` slices of :func:`topk_plan`'s columns; each radix
    pass (8-bit digits, bf16 from bit 8, f32 from bit 24) counts a 256-bin
    histogram of every slice's matching keys and sums them; a pass whose
    chosen bin is kept whole ends the select; when some ties at kth are
    dropped, each slice's tie count is prefix-summed over the lower slices
    and ranks the slice's ties in column order. ``top`` as
    :func:`topk_chunked_plain`'s (``None``: :func:`topk_plain`'s
    function). The same bits as those plain versions."""
    width = h.shape[-1]
    flat = h.reshape(-1, width)
    R, dev = flat.shape[0], flat.device
    key, value = _keys(flat)
    key = key.to(torch.int64)                                       # -1: never kept
    kc = key.clamp(min=0) if top is None else key.clamp(min=0, max=top - 1)
    S = _slice_cols(width, n_slices)
    pad = n_slices * S - width
    slice_of = torch.arange(n_slices * S, device=dev)[:width] // S
    first = 8 if h.dtype == torch.bfloat16 else 24
    prefix = torch.zeros(R, dtype=torch.int64, device=dev)
    remaining = torch.full((R,), k, dtype=torch.int64, device=dev)
    eq = torch.zeros(R, dtype=torch.int64, device=dev)
    live = torch.ones(R, dtype=torch.bool, device=dev)
    few = torch.zeros(R, dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev)
    for shift in range(first, -1, -8):
        above = ~((1 << (shift + 8)) - 1)
        match = (kc != 0) & ((kc & above) == prefix[:, None])
        digit = (kc >> shift) & 0xFF
        hist = torch.zeros((R, n_slices * 256), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, (slice_of * 256)[None, :] + digit, match.to(torch.int64))
        total = hist.view(R, n_slices, 256).sum(dim=1)              # summed over the slices
        ge = total.flip(1).cumsum(1).flip(1)                        # count(digit >= b)
        if shift == first:
            few = ge[:, 0] < k
            live &= ~few
        gt = ge - total
        b = ((gt < remaining[:, None]) & (ge >= remaining[:, None])).to(torch.int8).argmax(1)
        prefix = torch.where(live, prefix | (b << shift), prefix)
        remaining = torch.where(live, remaining - gt[rows, b], remaining)
        eq = torch.where(live, total[rows, b], eq)
        live &= remaining != eq
    kth = torch.where(few, 0, prefix)
    need = remaining if top is None else torch.where(kth == top - 1, k, remaining)
    simple = (kth == 0) | (need >= eq)
    ties = F.pad(key == kth[:, None], (0, pad)).view(R, n_slices, S)
    per_slice = ties.sum(2)
    before = per_slice.cumsum(1) - per_slice                        # ties of the lower slices
    rank = before[:, :, None] + ties.cumsum(2) - 1
    keep_tie = (ties & (rank < need[:, None, None])).view(R, -1)[:, :width]
    keep = torch.where(simple[:, None], key >= kth[:, None], (key > kth[:, None]) | keep_tie)
    out = torch.where(keep, value, torch.zeros((), dtype=h.dtype, device=dev))
    return out.reshape(h.shape)


def topk_route(width: int, k: int, dtype: torch.dtype) -> str:
    """The TopK mask kernel that takes rows of this width and dtype, as the
    JAX package's ``_topk_fwd_impl`` dispatches: bf16 rows up to 2^16 wide
    go to K5 (where JAX takes the composite kernel), f32 rows that pass the
    JAX single-block gate to K6, every other row to K7 (where JAX takes the
    width-chunked kernels, or ``lax.top_k``, which selects the same mask).
    :class:`ValueError` for another dtype or ``k`` outside ``(0, width]``."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"topk takes bf16 or f32 rows, got {dtype}")
    if not 0 < k <= width:
        raise ValueError(f"topk takes 0 < k <= width={width}, got {k}")
    if dtype == torch.bfloat16 and width <= _MAX_WIDTH:
        return "K5"
    if dtype == torch.float32 and _single_block_supported(width, k, 4):
        return "K6"
    return "K7"


def topk_forward(h: torch.Tensor, k: int) -> torch.Tensor:
    """The TopK mask without autograd, through the kernel that
    :func:`topk_route` names (its plain version on CPU tensors)."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk runs on cpu or cuda, got {h.device}")
    route = topk_route(h.shape[-1], k, h.dtype)
    if route == "K5":
        return topk_mask(h, k)
    if route == "K6":
        return topk_mask_f32(h, k)
    return topk_chunked(h, k)


_MASK_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
# each mask library's entry points: (h, out, R, W, k, vec, *extra ints, stream)
MASK_PROTOTYPES = {
    "topk_mask": {"topk_mask_launch": _MASK_ARGS + [ctypes.c_void_p]},
    "topk_mask_f32": {"topk_mask_f32_launch": _MASK_ARGS + [ctypes.c_void_p]},
    "topk_chunked": {"topk_chunked_launch": _MASK_ARGS + [ctypes.c_int, ctypes.c_void_p],
                     "topk_cluster_launch": _MASK_ARGS + [ctypes.c_int] * 3 + [ctypes.c_void_p]},
}


def _launch_mask(lib: str, fn_name: str, h: torch.Tensor, k: int,
                 extra: tuple = ()) -> torch.Tensor:
    """Launch a per-row TopK mask kernel ``fn(h, out, R, W, k, vec,
    *extra, stream)`` on a contiguous copy of ``h``'s rows; ``extra``
    holds the trailing int arguments (:data:`MASK_PROTOTYPES`)."""
    from crosscoder_tpu_torch.ops import _build

    width = h.shape[-1]
    if not 0 < k <= width:
        raise ValueError(f"{lib} kernel takes 0 < k <= width={width}, got {k}")
    flat = h.reshape(-1, width).contiguous()
    out = torch.empty_like(flat)
    vec = int(width % 8 == 0 and flat.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = getattr(_build.load(lib, MASK_PROTOTYPES[lib]), fn_name)
    code = fn(flat.data_ptr(), out.data_ptr(), flat.shape[0], width, k, vec, *extra,
              _build.stream(h.device))
    if code == _NO_CLUSTER:
        raise _build.KernelLaunchError(
            f"{lib} kernel: no thread-block cluster of this launch fits an SM "
            f"(cudaOccupancyMaxActiveClusters is 0; launch arguments {list(extra)})")
    _build.check(code, f"{lib} kernel")
    return out.reshape(h.shape)


def topk_mask(h: torch.Tensor, k: int) -> torch.Tensor:
    """K5, ``csrc/topk_mask.cu``: bf16 rows up to 2^16 wide. The plain
    version on CPU tensors. Counts its launches on ``topk.launches``."""
    if h.device.type == "cpu":
        return topk_plain(h, k)
    if h.dtype != torch.bfloat16 or h.shape[-1] > _MAX_WIDTH:
        raise ValueError(f"the K5 kernel takes bf16 rows up to {_MAX_WIDTH} wide, got "
                         f"{h.dtype} rows {h.shape[-1]} wide")
    out = _launch_mask("topk_mask", "topk_mask_launch", h, k)
    topk.launches += 1
    return out


def topk_mask_f32(h: torch.Tensor, k: int) -> torch.Tensor:
    """K6, ``csrc/topk_mask_f32.cu``: f32 rows staged whole in shared
    memory (up to ``_K6_MAX_WIDTH``). The plain version on CPU tensors."""
    if h.device.type == "cpu":
        return topk_plain(h, k)
    if h.dtype != torch.float32 or h.shape[-1] > _K6_MAX_WIDTH:
        raise ValueError(f"the K6 kernel takes f32 rows up to {_K6_MAX_WIDTH} wide, got "
                         f"{h.dtype} rows {h.shape[-1]} wide")
    out = _launch_mask("topk_mask_f32", "topk_mask_f32_launch", h, k)
    topk_mask_f32.launches += 1
    return out


topk_mask_f32.launches = 0


def topk_chunked(h: torch.Tensor, k: int) -> torch.Tensor:
    """K7, ``csrc/topk_chunked.cu``: bf16 or f32 rows of any width, by the
    route :func:`topk_plan` picks from the width before anything launches:
    a thread-block cluster a row holding it in shared memory, or, for
    wider rows, the streaming kernel. The plain version
    (:func:`topk_chunked_plain`) on CPU tensors. Counts its launches on
    ``topk_chunked.launches`` and by route on ``topk_chunked.by_route``."""
    if h.device.type == "cpu":
        return topk_chunked_plain(h, k)
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the K7 kernel takes bf16 or f32 rows, got {h.dtype}")
    route, n_blocks, cols = topk_plan(h.shape[-1], h.dtype)
    bf16 = int(h.dtype == torch.bfloat16)
    if route == "cluster":
        out = _launch_mask("topk_chunked", "topk_cluster_launch", h, k, (cols, n_blocks, bf16))
    else:
        out = _launch_mask("topk_chunked", "topk_chunked_launch", h, k, (bf16,))
    topk_chunked.launches += 1
    topk_chunked.by_route[route] += 1
    return out


topk_chunked.launches = 0
topk_chunked.by_route = {"cluster": 0, "streaming": 0}   # launches of each route


def _straight_through(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The masks' backward: ``g`` on the survivors; survivors that are
    exactly 0 get no gradient, as under relu's subgradient at 0."""
    return torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


class _TopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, k):
        out = topk_forward(h, k)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return _straight_through(out, g), None


def topk(h: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k of the ReLU'd entries of each row, zeros elsewhere,
    ties to the lowest index; differentiable (straight-through). Through
    K5, K6 or K7 as :func:`topk_route` picks (their plain versions on CPU
    tensors); :class:`ValueError` for another dtype or a bad ``k``."""
    return _TopK.apply(h, k)


topk.launches = 0              # K5's launches (topk_mask)


# ---------------------------------------------------------------------------
# K8: sparsify


_PART_BYTES = 32 * 1024       # K8's split route: a warp for each part of a row of this many bytes
_MAX_PARTS = 8                 # parts of a row: the warps of a 256-thread block
_SPLIT_MAX_K = 512             # the split route stages 8 x (k-1) pairs of 8 bytes a block
_SPARSIFY_PROTOTYPES = {"sparsify_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p]}


def _drained(flat: torch.Tensor) -> torch.Tensor:
    """The entries K8 drains: value > 0 (NaN, -0.0 and negatives never)."""
    return flat.float() > 0


def sparsify_plain(f: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`sparsify`."""
    width = f.shape[-1]
    flat = f.reshape(-1, width)
    R = flat.shape[0]
    pos = _drained(flat)
    rank = torch.cumsum(pos.to(torch.int32), dim=1) - 1
    vals = torch.zeros((R, k), dtype=f.dtype, device=f.device)
    idx = torch.zeros((R, k), dtype=torch.int32, device=f.device)
    r, c = torch.nonzero(pos & (rank < k - 1), as_tuple=True)
    vals[r, rank[r, c].long()] = flat[r, c]
    idx[r, rank[r, c].long()] = c.to(torch.int32)
    # a row with k or more positives ends with its last one in slot k-1
    total = pos.sum(dim=1)
    col = torch.arange(width, device=f.device)
    last = torch.where(pos, col, -1).amax(dim=1)
    over = torch.nonzero(total >= k, as_tuple=True)[0]
    vals[over, k - 1] = flat[over, last[over]]
    idx[over, k - 1] = last[over].to(torch.int32)
    return vals.reshape(*f.shape[:-1], k), idx.reshape(*f.shape[:-1], k)


def sparsify_plan(width: int, k: int, dtype: torch.dtype) -> tuple[str, int, int]:
    """How K8 launches on rows of this width: ``("split", P, S)``, ``P``
    warps a row (the largest power of two up to ``_MAX_PARTS`` parts of at
    least ``_PART_BYTES``), each draining ``S`` columns, for rows of two
    parts or more and ``2 <= k <= _SPLIT_MAX_K``; else ``("warp", 1,
    width)``, a warp a row, which takes any k."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    n = min(_MAX_PARTS, width * itemsize // _PART_BYTES)
    if n < 2 or not 2 <= k <= _SPLIT_MAX_K:
        return "warp", 1, width
    P = 1 << (n.bit_length() - 1)
    return "split", P, _slice_cols(width, P)


def sparsify_split_plain(f: torch.Tensor, k: int, n_parts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A plain model of K8's split route: each row cut into ``n_parts``
    parts of :func:`_slice_cols` columns; each part drains alone (its count,
    its first k-1 entries ranked within the part, its last entry); the
    parts' counts are prefix-summed, each part's entries land at its
    offset where that is below slot k-1, and the highest part with an
    entry fills slot k-1 when the row has k or more. The same bits as
    :func:`sparsify_plain` for any ``n_parts`` >= 1."""
    width = f.shape[-1]
    flat = f.reshape(-1, width)
    R, dev = flat.shape[0], flat.device
    S = _slice_cols(width, n_parts)
    pad = n_parts * S - width
    pos = F.pad(_drained(flat), (0, pad)).view(R, n_parts, S)
    count = pos.sum(2)                                              # [R, parts]
    local = pos.to(torch.int32).cumsum(2) - 1                       # rank within the part
    staged = pos & (local < k - 1)
    slot = (count.cumsum(1) - count)[:, :, None] + local            # offset by the lower parts
    r, p, c = torch.nonzero(staged & (slot < k - 1), as_tuple=True)
    col = p * S + c
    vals = torch.zeros((R, k), dtype=f.dtype, device=dev)
    idx = torch.zeros((R, k), dtype=torch.int32, device=dev)
    vals[r, slot[r, p, c].long()] = flat[r, col]
    idx[r, slot[r, p, c].long()] = col.to(torch.int32)
    parts = torch.arange(n_parts, device=dev)
    top = torch.where(count > 0, parts, -1).amax(1)                 # the highest part with one
    cols = torch.arange(S, device=dev)
    last_in = torch.where(pos, cols, -1).amax(2)                    # each part's last column
    over = torch.nonzero(count.sum(1) >= k, as_tuple=True)[0]
    last = top[over] * S + last_in[over, top[over]]
    vals[over, k - 1] = flat[over, last]
    idx[over, k - 1] = last.to(torch.int32)
    return vals.reshape(*f.shape[:-1], k), idx.reshape(*f.shape[:-1], k)


def sparsify(f: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals [..., k] in f.dtype, idx [..., k] int32)``: the entries > 0
    of each row in ascending index order, ``(0, 0)``-padded; a row with
    more than k of them keeps its last in slot k-1. Not differentiable.
    The plain version on CPU tensors, K8 on CUDA tensors (or
    :class:`ValueError`), by the route :func:`sparsify_plan` picks before
    anything launches. Counts its launches on ``sparsify.launches`` and by
    route on ``sparsify.by_route``."""
    if f.device.type == "cpu":
        return sparsify_plain(f, k)
    if f.device.type != "cuda":
        raise ValueError(f"sparsify runs on cpu or cuda, got {f.device}")
    from crosscoder_tpu_torch.ops import _build

    if f.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"sparsify kernel takes bf16 or f32 rows, got {f.dtype}")
    if k < 1:
        raise ValueError(f"sparsify kernel takes k >= 1, got {k}")
    width = f.shape[-1]
    route, parts, cols = sparsify_plan(width, k, f.dtype)
    flat = f.reshape(-1, width)
    if not flat.is_contiguous():
        flat = flat.contiguous()
    R = flat.shape[0]
    vals = torch.empty((R, k), dtype=f.dtype, device=f.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=f.device)
    vec = int(width % 8 == 0 and flat.data_ptr() % 16 == 0)
    code = _build.load("sparsify", _SPARSIFY_PROTOTYPES).sparsify_launch(
        flat.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, width, k,
        int(f.dtype == torch.bfloat16), vec, parts, cols, _build.stream(f.device))
    _build.check(code, "sparsify kernel")
    sparsify.launches += 1
    sparsify.by_route[route] += 1
    return vals.reshape(*f.shape[:-1], k), idx.reshape(*f.shape[:-1], k)


sparsify.launches = 0
sparsify.by_route = {"warp": 0, "split": 0}   # launches of each route


# ---------------------------------------------------------------------------
# K9: BatchTopK (global threshold)

_BATCHTOPK_T = 15              # thresholds per bisection pass (the JAX package's)


def _n_bisect_passes(range_size: int, t: int = _BATCHTOPK_T) -> int:
    """Passes until ``hi - lo == 1`` from a range of ``range_size``."""
    n, r = 0, range_size
    while r > 1:
        r = -((1 - r) // t)
        n += 1
    return n


def _bt_patterns(h: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``(patterns int64 [numel], top)``: each entry's clamped pattern (the
    K9 rule, ``csrc/batchtopk.cu``: sign-set → 0, NaN → the pattern below
    the top of the range, bf16 in 15 bits, f32 in 31) and ``top``, a pattern
    above every one of them."""
    if h.dtype == torch.bfloat16:
        u = h.reshape(-1).view(torch.int16).to(torch.int64) & 0xFFFF
        neg, nan_neg, top = 0x8000, 0xFF80, 0x7FFF
    elif h.dtype == torch.float32:
        u = h.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        neg, nan_neg, top = 0x80000000, 0xFF800000, 0x7FFFFFFF
    else:
        raise ValueError(f"batchtopk takes bf16 or f32 pre-activations, got {h.dtype}")
    p = torch.where(u >= neg, torch.where(u > nan_neg, top - 1, 0), torch.clamp(u, max=top - 1))
    return p, top


def bisection_mids(lo: int, hi: int, t: int = _BATCHTOPK_T) -> list[int]:
    """The ``t`` candidate patterns of one bisection pass over ``[lo, hi)``
    (``lo < hi - 1``), ascending, each above ``lo``."""
    q, rem = divmod(hi - lo - 1, t)
    return [lo + 1 + q * j + (rem * j) // t for j in range(t)]


def narrow(lo: int, hi: int, mids: list[int], counts, kk: int) -> tuple[int, int]:
    """``[lo, hi)`` after a pass whose ``counts[j]`` are the entries at or
    above ``mids[j]``: the invariant ``count(>= lo) >= kk > count(>= hi)``
    kept."""
    num_ge = sum(int(c) >= kk for c in counts)
    t = len(mids)
    return (mids[num_ge - 1] if num_ge > 0 else lo), (mids[num_ge] if num_ge < t else hi)


def kth_largest_pattern(pats: torch.Tensor, kk: int, hi: int) -> int:
    """The largest ``p`` in ``[0, hi)`` with ``count(pats >= p) >= kk``, by
    the JAX package's multi-threshold bisection (T = 15 candidates a pass;
    invariant ``count(>= lo) >= kk > count(>= hi)``)."""
    lo = 0
    for _ in range(_n_bisect_passes(hi)):
        mids = bisection_mids(lo, hi)
        lo, hi = narrow(lo, hi, mids, [(pats >= m).sum() for m in mids], kk)
    return lo


def batchtopk_select_plain(h: torch.Tensor, kk: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`batchtopk_select`."""
    pats, top = _bt_patterns(h)
    return torch.tensor([kth_largest_pattern(pats, kk, top)], dtype=torch.int32,
                        device=h.device)


def batchtopk_emit_plain(h: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`batchtopk_emit`."""
    pats, _ = _bt_patterns(h)
    t = kth.to(torch.int64).reshape(())
    out = torch.where((pats >= t) & (pats > 0), pats, torch.zeros((), dtype=pats.dtype,
                                                                   device=h.device))
    view = torch.int16 if h.dtype == torch.bfloat16 else torch.int32
    return out.to(view).view(h.dtype).reshape(h.shape)


def _check_bt(h: torch.Tensor, name: str) -> torch.Tensor:
    if h.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {h.device}")
    if h.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel takes bf16 or f32 pre-activations, got {h.dtype}")
    return h.reshape(-1).contiguous()


_BT_HEAD = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
BATCHTOPK_PROTOTYPES = {
    "batchtopk_select_bf16": _BT_HEAD + [ctypes.c_void_p] * 4,
    "batchtopk_select_f32": _BT_HEAD + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "batchtopk_emit": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
}


def batchtopk_select(h: torch.Tensor, kk: int) -> torch.Tensor:
    """K9 select: the device int32 ``[1]`` pattern of the ``kk``-th largest
    ReLU'd entry of ``h`` (0 when fewer than ``kk`` entries are positive),
    with no host sync. The plain version on CPU tensors, the kernel on CUDA
    tensors (or :class:`ValueError`)."""
    if h.device.type == "cpu":
        return batchtopk_select_plain(h, kk)
    from crosscoder_tpu_torch.ops import _build

    flat = _check_bt(h, "batchtopk_select")
    if kk < 1:
        raise ValueError(f"batchtopk_select takes kk >= 1, got {kk}")
    n = flat.numel()
    vec = int(flat.data_ptr() % 16 == 0)
    kth = torch.empty(1, dtype=torch.int32, device=h.device)
    stream = _build.stream(h.device)
    lib = _build.load("batchtopk", BATCHTOPK_PROTOTYPES)
    if h.dtype == torch.bfloat16:
        hist = torch.zeros(_BINS + 1, dtype=torch.int64, device=h.device)   # + the ticket
        code = lib.batchtopk_select_bf16(flat.data_ptr(), n, kk, vec, hist.data_ptr(),
                                         hist[_BINS:].data_ptr(), kth.data_ptr(), stream)
    else:
        top = 0x7FFFFFFF
        state = torch.zeros(2 + _BATCHTOPK_T + 1, dtype=torch.int64)
        state[1] = top
        state = state.to(h.device)
        code = lib.batchtopk_select_f32(flat.data_ptr(), n, kk, vec, state.data_ptr(),
                                        kth.data_ptr(), _n_bisect_passes(top), stream)
    _build.check(code, "batchtopk select kernel")
    batchtopk_select.launches += 1
    return kth


batchtopk_select.launches = 0
_BINS = 1 << 15


def batchtopk_emit(h: torch.Tensor, kth: torch.Tensor) -> torch.Tensor:
    """K9 emit: ``h``'s entries whose clamped pattern is ``>= kth`` and
    ``> 0``, as the values of those patterns, zeros elsewhere (``kth`` a
    device int32 ``[1]``). The plain version on CPU tensors, the kernel on
    CUDA tensors (or :class:`ValueError`)."""
    if h.device.type == "cpu":
        return batchtopk_emit_plain(h, kth)
    from crosscoder_tpu_torch.ops import _build

    flat = _check_bt(h, "batchtopk_emit")
    kth = kth.to(device=h.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(flat)
    vec = int(flat.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    code = _build.load("batchtopk", BATCHTOPK_PROTOTYPES).batchtopk_emit(
        flat.data_ptr(), out.data_ptr(), flat.numel(), kth.data_ptr(),
        int(h.dtype == torch.bfloat16), vec, _build.stream(h.device))
    _build.check(code, "batchtopk emit kernel")
    batchtopk_emit.launches += 1
    return out.reshape(h.shape)


batchtopk_emit.launches = 0


def batchtopk_budget(h: torch.Tensor, k: int) -> int:
    """``kk = min(k · rows, numel)``: the entries BatchTopK keeps (ties
    aside), over every leading axis of ``h``."""
    rows = h.numel() // max(h.shape[-1], 1) if h.dim() else 1
    return min(k * rows, h.numel())


def fixed_threshold_pattern(threshold: float, dtype: torch.dtype) -> int:
    """The pattern of a fixed BatchTopK threshold, as the JAX package
    computes it: rounded to ``dtype``, its f32 pattern, a sign-set pattern
    clamped to 0 (``<= 0`` keeps every positive entry), bf16 shifted to 16
    bits."""
    pat = torch.tensor([threshold], dtype=dtype).float().view(torch.int32).item()
    pat = max(pat, 0)
    return pat >> 16 if dtype == torch.bfloat16 else pat


class _BatchTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, k):
        out = batchtopk_emit(h, batchtopk_select(h, batchtopk_budget(h, k)))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return _straight_through(out, g), None


class _BatchTopKFixed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, threshold):
        kth = torch.tensor([fixed_threshold_pattern(threshold, h.dtype)], dtype=torch.int32,
                           device=h.device)
        out = batchtopk_emit(h, kth)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return _straight_through(out, g), None


def batchtopk(h: torch.Tensor, k: int) -> torch.Tensor:
    """BatchTopK of the ReLU'd entries of ``h`` (bf16 or f32): keep every
    entry at or above the ``min(k·rows, numel)``-th largest of the whole
    batch (all ties kept), zeros elsewhere; straight-through gradient on
    the survivors. K9 select + emit on CUDA tensors, their plain versions
    on CPU tensors."""
    return _BatchTopK.apply(h, k)


def batchtopk_fixed(h: torch.Tensor, threshold: float) -> torch.Tensor:
    """BatchTopK's eval mode: keep the positive entries at or above a fixed
    ``threshold`` (the K9 emit alone); straight-through gradient."""
    return _BatchTopKFixed.apply(h, float(threshold))

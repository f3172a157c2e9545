"""Ragged paged attention: per-document attention over fixed-size KV pages.

Port of :mod:`crosscoder_tpu.ops.paged_attention`. Queries and K/V arrive
padded per document ``[D, S, ...]`` with ragged ``lengths``; K/V are cut
into ``page_size``-token pages, and attention for document ``d`` reads
only its own ``ceil(len_d/page)`` pages.

Two implementations behind one wrapper, :func:`paged_attention`:

- the plain PyTorch version, :func:`ragged_attention_reference`: padded
  masked-softmax attention with the ragged length mask, the same op
  sequence as the JAX reference (GQA folded as ``[B, S, KV, g, hd]``,
  fp32 logits, softcap, causal/window/length masks, ``NEG_INF`` fill). The
  wrapper takes it for CPU tensors only;
- the hand-written Hopper kernels in ``csrc/paged_attention.cu`` (grid
  ``(doc, kv_head, q_tile)``, online softmax over the visible pages), one
  by dtype (:func:`kernel_route`): bf16 on the tensor cores (128 query
  rows a block, two consumer warpgroups of ``wgmma`` for Q·Kᵀ and P·V, Q
  and each K/V page loaded by TMA from a producer warp into a ring of
  mbarrier-guarded stages), f32 on the CUDA cores (32 rows a block, fp32
  FMAs: a tensor-core f32 product is TF32, too coarse for the f32 bar).
  Both read ``k`` and ``v`` where they lie: page ``j`` of document ``d`` is
  rows ``[j·page, (j+1)·page)`` of ``k[d]``, so no page pool is built
  (:func:`paginate_kv` is the JAX package's pool, kept for its parity
  test). This is a dispatch, not a fallback: each route is its own kernel
  and either raises on failure. For a CUDA tensor the wrapper launches one
  or raises; shapes neither takes raise :class:`ValueError`.

The kernels' online softmax reassociates the reduction (and the bf16 one
rounds the probabilities to bf16 for P·V), so kernel vs plain is allclose
(about 1e-5 in fp32, 2e-2 in bf16) on valid rows, not bitwise. Rows at
``t >= lengths[d]`` are meaningless in both (the kernels write 0 for
tiles wholly past the length); every caller discards them.
"""

from __future__ import annotations

import ctypes

import torch

# the attention mask fill shared by every attention path of the port
NEG_INF = -2.3819763e38

_KERNEL = "paged_attention"
_HEAD_DIMS = (128, 256)
PAGE_SIZES = (32, 64)   # the page sizes K1 takes
_ROWS = 32          # query rows a block of the f32 kernel (csrc kRows); bf16 takes 128
_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
_PROTOTYPES = {
    "rpa_launch": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}


def kernel_route(dtype: torch.dtype) -> str:
    """The kernel :func:`paged_attention` launches for CUDA tensors of
    ``dtype``: ``"tensor_cores"`` (bf16) or ``"cuda_cores"`` (f32)."""
    if dtype not in _ROUTES:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, got {dtype}")
    return _ROUTES[dtype]


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def ragged_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor | None,
    *,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
    is_local: bool = False,
) -> torch.Tensor:
    """Masked-softmax attention over (per-document) padded buffers.

    ``q [B, S, H, hd]`` (unscaled), ``k``/``v [B, S, KV, hd]``; ``lengths
    [B]`` adds the key-side validity mask (None: the padded forward, no
    per-row mask). ``window`` is the sliding-window width, applied when
    ``is_local``. Returns ``[B, S, H*hd]`` in ``v``'s dtype.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    pos = torch.arange(S, device=q.device)
    qh = q.reshape(B, S, KV, g, hd) * scale
    logits = torch.einsum("bqkgh,bskh->bkgqs", qh.float(), k.float())
    if softcap:
        logits = _softcap(logits, softcap)
    causal = pos[:, None] >= pos[None, :]                              # [S, S]
    mask = causal & (pos[:, None] - pos[None, :] < window) if (is_local and window) else causal
    if lengths is None:
        maskb = mask[None, None, None]
    else:
        in_len = pos[None, None, :] < lengths.to(q.device)[:, None, None]   # [B,1,S]
        maskb = (mask[None] & in_len)[:, None, None]                  # [B,1,1,S,S]
    # the fill made on the device: a host scalar copied in would sync the stream
    logits = torch.where(maskb, logits, torch.full((), NEG_INF, dtype=logits.dtype,
                                                   device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, S, H * hd)


def paginate_kv(
    k: torch.Tensor, v: torch.Tensor, page_size: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """View per-document padded K/V ``[D, S, KV, hd]`` as a page pool.

    Returns ``(kv_pages [P, 2, KV, page, hd], page_tbl [D, S//page] int32)``
    with the dense identity table ``page_tbl[d, j] = d*(S//page) + j``.
    """
    D, S, KV, hd = k.shape
    if S % page_size:
        raise ValueError(f"seq_len {S} not divisible by page_size {page_size}")
    n_pages = S // page_size
    kp = k.reshape(D * n_pages, page_size, KV, hd).transpose(1, 2)
    vp = v.reshape(D * n_pages, page_size, KV, hd).transpose(1, 2)
    kv_pages = torch.stack([kp, vp], dim=1).contiguous()     # [P, 2, KV, page, hd]
    page_tbl = (
        torch.arange(D, dtype=torch.int32, device=k.device)[:, None] * n_pages
        + torch.arange(n_pages, dtype=torch.int32, device=k.device)[None]
    )
    return kv_pages, page_tbl


def paged_attention_plain(
    q, k, v, lengths, *, page_size: int, scale: float, softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version with :func:`paged_attention`'s signature."""
    del page_size
    return ragged_attention_reference(
        q, k, v, lengths, scale=scale, softcap=softcap, window=window,
        is_local=bool(window),
    )


def check_supported(q, k, v, lengths, page_size: int) -> None:
    """Raise :class:`ValueError` naming any shape or type the kernel does
    not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [D,S,H,hd], k/v [D,S,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    D, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[:2] != (D, S) or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"paged attention kernel takes float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"paged attention kernel takes head_dim in {_HEAD_DIMS}, got {hd}")
    if page_size not in PAGE_SIZES:
        raise ValueError(f"paged attention kernel takes page_size in {PAGE_SIZES}, got {page_size}")
    if S % page_size:
        raise ValueError(f"seq_len {S} not divisible by page_size {page_size}")
    if H % KV or _ROWS % (H // KV):
        raise ValueError(f"paged attention kernel needs the query group H/KV "
                         f"({H}/{KV}) to divide {_ROWS}")
    if lengths.shape != (D,):
        raise ValueError(f"lengths must be [{D}], got {tuple(lengths.shape)}")


def _operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address, which the bf16
    kernel's tensor maps and the f32 kernel's 16-byte loads need; a copy
    only where it is not so already."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def paged_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    *,
    page_size: int,
    scale: float,
    softcap: float = 0.0,
    window: int = 0,
) -> torch.Tensor:
    """Ragged attention ``[D, S, H*hd]``: the plain version on CPU tensors,
    the Hopper kernel of :func:`kernel_route` on CUDA tensors (or
    :class:`ValueError`).
    ``window=0`` means global/causal; ``window > 0`` a sliding window."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, lengths, page_size=page_size,
                                     scale=scale, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, got {q.device}")
    from crosscoder_tpu_torch.ops import _build

    check_supported(q, k, v, lengths, page_size)
    route = kernel_route(q.dtype)
    D, S, H, hd = q.shape
    KV = k.shape[2]
    q, k, v = (_operand(x) for x in (q, k, v))
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load(_KERNEL, _PROTOTYPES)
    code = lib.rpa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), D, S, H, KV, hd, page_size,
        int(q.dtype == torch.bfloat16), float(scale), float(softcap), int(window),
        _build.stream(q.device),
    )
    _build.check(code, f"paged_attention kernel ({route})")
    paged_attention.launches += 1
    paged_attention.by_route[route] += 1
    paged_attention.last_route = route
    return out.reshape(D, S, H * hd)


paged_attention.launches = 0
paged_attention.by_route = {"tensor_cores": 0, "cuda_cores": 0}   # launches of each route
paged_attention.last_route = None     # kernel_route of the latest launch

"""Fused encoder→TopK: ``(vals, idx)`` of ``relu(x·W + b)`` without the
``[B, width]`` pre-activation matrix.

Port of :func:`crosscoder_tpu.ops.fused_encoder_topk.fused_topk_encode`
with the same contract: ``(vals [B, k], idx [B, k] int32)``, ascending
index, ``(0.0, 0)``-padded; the pre-activations are rounded to the compute
dtype before selection (as ``crosscoder.pre_acts`` does); selection runs on
the sign-clamped f32 bit patterns (every NaN above +inf, ``-0.0`` and
negatives at 0); ties go to the lowest index; a NaN occupies a slot and is
dropped at emit.

Two implementations behind :func:`fused_topk_encode`:

- the plain PyTorch version, :func:`fused_topk_encode_plain`: fp32
  ``torch.matmul`` plus bias, the cast, then an exact top-k through a
  composite int64 key (selection key, then inverted index), since
  ``torch.topk``'s order among ties is unspecified; then a sort by index.
  The wrapper takes it for CPU tensors only;
- the hand-written Hopper kernel in ``csrc/fused_topk.cu`` (two
  deterministic passes: per-tile candidates, then a per-row merge). For a
  CUDA tensor the wrapper launches it or raises.

Both sum the matmul in fp32 in different orders, so they agree bitwise
where the sums are exact (integer-valued operands) and to rounding
elsewhere. The int8 block-scaled variant (``quant_block``) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL = "fused_topk"
_SENT = 0x7F800001            # every NaN: just above +inf's 0x7F800000
_INF_BITS = 0x7F800000
_MAX_K = 128
_CW = 128                     # dictionary columns per tile (csrc kCW)
_SMEM_LIMIT = 232_448         # bytes of shared memory a Hopper block may use


def select_keys(h: torch.Tensor) -> torch.Tensor:
    """int32 selection keys of the (compute-dtype) pre-activations: the f32
    bit pattern where ``h > 0``, ``_SENT`` for NaN, 0 elsewhere."""
    hf = h.float()
    bits = hf.view(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=h.device)
    sent = torch.full((), _SENT, dtype=torch.int32, device=h.device)
    return torch.where(torch.isnan(hf), sent, torch.where(hf > 0, bits, zero))


def topk_from_keys(keys: torch.Tensor, k: int, out_dtype: torch.dtype
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-k of int32 ``keys [B, width]`` by (key desc, index
    asc) among positive keys, emitted in ascending index order."""
    B, width = keys.shape
    col = torch.arange(width, device=keys.device, dtype=torch.int64)
    comp = (keys.to(torch.int64) << 32) | (0x7FFFFFFF - col)
    comp = torch.where(keys > 0, comp, torch.zeros((), dtype=torch.int64, device=keys.device))
    top, _ = torch.topk(comp, k, dim=-1)                    # unique values: exact
    key = (top >> 32).to(torch.int32)
    idx = (0x7FFFFFFF - (top & 0xFFFFFFFF)).to(torch.int32)
    emit = (key > 0) & (key <= _INF_BITS)
    order = torch.sort(torch.where(emit, idx, torch.iinfo(torch.int32).max), dim=-1).indices
    key = torch.gather(key, 1, order)
    idx = torch.gather(idx, 1, order)
    emit = torch.gather(emit, 1, order)
    vals = torch.where(emit, key.view(torch.float32), torch.zeros((), device=keys.device))
    return vals.to(out_dtype), torch.where(emit, idx, torch.zeros_like(idx))


def fused_topk_encode_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_topk_encode`."""
    h = (torch.matmul(x2.float(), W2.float()) + b_enc.float()).to(x2.dtype)
    return topk_from_keys(select_keys(h), k, x2.dtype)


def check_supported(x2, W2, b_enc, k: int) -> None:
    """Raise :class:`ValueError` naming any shape or type the kernel does
    not take."""
    if x2.dim() != 2 or W2.dim() != 2 or W2.shape[0] != x2.shape[1]:
        raise ValueError(f"expected x2 [B, nd] and W2 [nd, width], got "
                         f"{tuple(x2.shape)}, {tuple(W2.shape)}")
    B, nd = x2.shape
    width = W2.shape[1]
    if b_enc.shape != (width,):
        raise ValueError(f"b_enc must be [{width}], got {tuple(b_enc.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16) or W2.dtype != x2.dtype:
        raise ValueError(f"fused topk kernel takes float32 or bfloat16, got "
                         f"{x2.dtype}/{W2.dtype}")
    if not 0 < k <= min(_MAX_K, width):
        raise ValueError(f"fused topk kernel takes 0 < k <= min({_MAX_K}, width={width}), got {k}")
    if width % 8:
        raise ValueError(f"fused topk kernel takes a dictionary width divisible by 8, got {width}")
    x_bytes = 8 * nd * x2.element_size()
    smem1 = -(-max(x_bytes, 16 * 8 * _CW * 4) // 16) * 16 + 8 * _CW * 8
    if smem1 > _SMEM_LIMIT:
        raise ValueError(
            f"fused topk kernel: nd={nd} needs {smem1} bytes of shared memory, over "
            f"{_SMEM_LIMIT}")


def _merge_group(k: int) -> int:
    """Tiles whose k candidates (and the k winners) one merge block stages
    in shared memory, 1 KB left for its static shared memory."""
    return ((_SMEM_LIMIT - 1024) // 8 - k) // k


def fused_topk_encode(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals [B, k] in x2.dtype, idx [B, k] int32)`` of the top-k of
    ``relu(cast(x2·W2 + b_enc))``, ascending index, ``(0, 0)``-padded.
    ``x2 [B, nd]`` and ``W2 [nd, width]`` in the compute dtype; ``b_enc``
    any float dtype, applied in fp32. The plain version on CPU tensors,
    the Hopper kernel on CUDA tensors (or :class:`ValueError`)."""
    if x2.device.type == "cpu":
        return fused_topk_encode_plain(x2, W2, b_enc, k)
    if x2.device.type != "cuda":
        raise ValueError(f"fused_topk_encode runs on cpu or cuda, got {x2.device}")
    from crosscoder_tpu_torch.ops import _build

    check_supported(x2, W2, b_enc, k)
    B, nd = x2.shape
    width = W2.shape[1]
    x2 = x2.contiguous()
    W2 = W2.contiguous()
    if W2.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError("fused topk kernel needs 16-byte aligned x2 and W2")
    b32 = b_enc.to(torch.float32).contiguous()
    n_tiles = -(-width // _CW)
    group = min(n_tiles, _merge_group(k))
    cand = torch.empty((B, n_tiles, k), dtype=torch.int64, device=x2.device)
    cand2 = torch.empty((B, -(-n_tiles // group) if group < n_tiles else 0, k),
                        dtype=torch.int64, device=x2.device)
    vals = torch.empty((B, k), dtype=x2.dtype, device=x2.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=x2.device)
    lib = _build.load(_KERNEL)
    fn = lib.fused_topk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(
        x2.data_ptr(), W2.data_ptr(), b32.data_ptr(), cand.data_ptr(), cand2.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), B, nd, width, k, group, int(x2.dtype == torch.bfloat16),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(code, "fused topk kernel")
    fused_topk_encode.launches += 1
    return vals, idx


fused_topk_encode.launches = 0

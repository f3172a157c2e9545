"""Fused encoder→TopK and encoder→BatchTopK: the selection of
``relu(x·W + b)`` without the ``[B, width]`` pre-activation matrix.

Port of :mod:`crosscoder_tpu.ops.fused_encoder_topk`. Three kernels, each
with a plain PyTorch version in this module; a wrapper takes the plain
version for CPU tensors only, and for a CUDA tensor launches the
hand-written Hopper kernel or raises (:class:`ValueError` for a shape the
kernel does not take, ``KernelBuildError`` / ``KernelLaunchError``
otherwise). The JAX wrappers fall back to the dense encode on a shape their
kernels do not take; the port refuses instead.

In bf16, K2 and K4 compute the product on the tensor cores with one shared
tile (``csrc/encoder_tile_sm90.cuh``): a persistent grid over [128, 128]
output tiles, TMA loads of x and W into a shared-memory ring, two
warpgroups of ``wgmma`` with fp32 sums, the kernel's selection in the
epilogue. TMA reads rows 16 bytes at a time, so bf16 takes ``nd`` and the
width divisible by 8 and 16-byte aligned operands (:func:`check_supported`,
:func:`check_supported_bt`). In float32 they keep fp32 FMAs on the CUDA
cores, since a tensor-core f32 product is TF32 and would change results.
At the training shape ([4096, 4608] x [4608, 32768]) both are bound by the
product's operations (1.2507 ms at the bf16 tensor-core peak); at the
serve shape ([8, 4608] x [4608, 16384]) K2 is bound by reading W once
(0.0451 ms).

- :func:`fused_topk_encode` (K2, ``csrc/fused_topk.cu``; replaces the TPU
  kernel ``_fused_topk_kernel``): ``(vals [B, k], idx [B, k] int32)``,
  ascending index, ``(0.0, 0)``-padded; the
  pre-activations are rounded to the compute dtype before selection (as
  ``crosscoder.pre_acts`` does); selection runs on the sign-clamped f32 bit
  patterns (every NaN above +inf, ``-0.0`` and negatives at 0); ties go to
  the lowest index; a NaN occupies a slot and is dropped at emit. The plain
  version (:func:`fused_topk_encode_plain`) is an fp32 ``torch.matmul``
  plus bias, the cast, then an exact top-k through a composite int64 key
  (selection key, then inverted index), since ``torch.topk``'s order among
  ties is unspecified. The kernel sums the product in another order, so
  the two agree bitwise where the sums are exact (integer-valued
  operands) and to rounding elsewhere.
- ``quant_block > 0`` (K3, :func:`fused_topk_encode_q`,
  ``csrc/fused_topk_q.cu``; replaces ``_fused_topk_kernel_q``): the same
  selection over the int8 block-scaled product of the JAX
  ``_tile_preacts_quant``: x quantized per (row, block),
  W per (block, column) (:func:`crosscoder_tpu_torch.ops.quant.quantize_contraction`),
  each block's integer product exact, folded into f32 as ``acc + (p ·
  xs[:, b]) · ws[b, :]`` for b = 0…nb−1. The kernel runs on the same tile
  with the int8 ``wgmma`` (both operands K-major, the scales transposed:
  :func:`q_operands`) in bf16 and f32 alike, and folds each block in the
  main loop; kernel and plain version (:func:`fused_topk_encode_q_plain`)
  round each step alike: bitwise on any input.
- :func:`fused_batchtopk_encode` (K4, ``csrc/fused_batchtopk.cu``; replaces
  ``_fused_bt_bisect_kernel`` and ``_fused_bt_emit_kernel``): the
  masked ``[B, width]`` BatchTopK activations, every entry whose clamped
  pattern (K9's rule, :func:`topk_pallas.batchtopk_select`) reaches the
  ``min(k·B, B·width)``-th largest of the batch, all ties kept. Select
  (:func:`fused_batchtopk_select`, the threshold as a device int32) and emit
  (:func:`fused_batchtopk_emit`) each recompute the product. The plain
  versions round the dense pre-activations as ``pre_acts`` does and run
  K9's plain select and emit: bitwise to the kernels on integer-valued
  operands. The count entry (:func:`fused_batchtopk_count`, the same
  source) recomputes the product once more and counts the entries at or
  above each of one bisection pass's candidate patterns: the threshold
  over a rank grid sums these counts over the ranks
  (:func:`crosscoder_tpu_torch.models.crosscoder.get_losses`).

Each library's entry points get their ctypes prototypes once, when it
loads (:data:`PROTOTYPES`), and each launch passes :func:`_build.stream`.
"""

from __future__ import annotations

import ctypes

import torch

from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.ops import topk_pallas as tp

_SENT = 0x7F800001            # every NaN: just above +inf's 0x7F800000
_INF_BITS = 0x7F800000
_MAX_K = 128
_CW = 128                     # dictionary columns per tile (csrc kCW)
_SMEM_LIMIT = 232_448         # bytes of shared memory a Hopper block may use
_MAX_MIDS = 32                # candidate patterns a count pass takes (csrc kMaxMids)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library's entry points: pointers, then ints, then the stream
PROTOTYPES = {
    "fused_topk": {"fused_topk_launch": [_P] * 7 + [_I] * 6 + [_P]},
    "fused_topk_q": {"fused_topk_q_launch": [_P] * 9 + [_I] * 8 + [_P]},
    "fused_batchtopk": {
        "fused_bt_select": [_P] * 5 + [_I] * 3 + [_LL, _I, _P],
        "fused_bt_count": [_P] * 4 + [_I] * 7 + [_P],
        "fused_bt_emit": [_P] * 5 + [_I] * 4 + [_P],
    },
}


def _lib(name: str):
    from crosscoder_tpu_torch.ops import _build

    return _build.load(name, PROTOTYPES[name])


def _bt_state_bytes() -> int:
    """Bytes of K4 select's device state (``fused_bt_state_bytes``)."""
    global _STATE_BYTES
    if _STATE_BYTES is None:
        fn = _lib("fused_batchtopk").fused_bt_state_bytes
        fn.restype = ctypes.c_longlong
        _STATE_BYTES = int(fn())
    return _STATE_BYTES


_STATE_BYTES = None


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


def _pre_acts_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor) -> torch.Tensor:
    """``(x2·W2 + b).to(x2.dtype)``, summed in fp32: ``pre_acts``' rounding."""
    return (torch.matmul(x2.float(), W2.float()) + b_enc.float()).to(x2.dtype)


def fused_topk_encode_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                            k: int, *, quant_block: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_topk_encode`."""
    if quant_block:
        return fused_topk_encode_q_plain(x2, W2, b_enc, k, quant_block)
    return topk_from_keys(select_keys(_pre_acts_plain(x2, W2, b_enc)), k, x2.dtype)


def fused_topk_encode_q_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                              k: int, quant_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_topk_encode_q`: each
    block's integer product exactly (int8 in float64, exact while
    ``block·127² < 2^53``), rescaled in f32 in the JAX kernel's order."""
    xq, xs, wq, ws = quant.quantize_contraction(x2, W2, quant_block)
    acc = torch.zeros((x2.shape[0], W2.shape[1]), dtype=torch.float32, device=x2.device)
    for b in range(xs.shape[1]):
        lo, hi = b * quant_block, (b + 1) * quant_block
        p = torch.matmul(xq[:, lo:hi].double(), wq[lo:hi].double()).float()
        acc = acc + p * xs[:, b:b + 1] * ws[b:b + 1]
    h = (acc + b_enc.float()).to(x2.dtype)
    return topk_from_keys(select_keys(h), k, x2.dtype)


def _check_operands(x2, W2, b_enc, what: str) -> None:
    if x2.dim() != 2 or W2.dim() != 2 or W2.shape[0] != x2.shape[1]:
        raise ValueError(f"expected x2 [B, nd] and W2 [nd, width], got "
                         f"{tuple(x2.shape)}, {tuple(W2.shape)}")
    width = W2.shape[1]
    if b_enc.shape != (width,):
        raise ValueError(f"b_enc must be [{width}], got {tuple(b_enc.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16) or W2.dtype != x2.dtype:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got {x2.dtype}/{W2.dtype}")
    if width % 8:
        raise ValueError(f"{what} kernel takes a dictionary width divisible by 8, got {width}")


def _check_tma(x2, W2, what: str) -> None:
    """The bf16 tensor-core tile's TMA loads: 16-byte row strides (``nd``
    and the width divisible by 8) and 16-byte aligned operands."""
    nd = x2.shape[1]
    if nd % 8:
        raise ValueError(f"{what} kernel takes bfloat16 nd divisible by 8 (16-byte TMA rows), "
                         f"got nd={nd}")
    for name, t in (("x2", x2), ("W2", W2)):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs a 16-byte aligned {name} for TMA, got "
                             f"data_ptr % 16 = {t.data_ptr() % 16}")


def check_supported(x2, W2, b_enc, k: int) -> None:
    """Raise :class:`ValueError` naming any shape or type the K2 kernel
    does not take: bf16 the tensor-core tile's TMA gates, float32 the
    shared memory of its CUDA-core pass (8 rows of x staged)."""
    _check_operands(x2, W2, b_enc, "fused topk")
    nd, width = W2.shape
    if not 0 < k <= min(_MAX_K, width):
        raise ValueError(f"fused topk kernel takes 0 < k <= min({_MAX_K}, width={width}), got {k}")
    if x2.dtype == torch.bfloat16:
        _check_tma(x2, W2, "fused topk")
        return
    x_bytes = 8 * nd * x2.element_size()
    smem1 = -(-max(x_bytes, 16 * 8 * _CW * 4) // 16) * 16 + 8 * _CW * 8
    if smem1 > _SMEM_LIMIT:
        raise ValueError(
            f"fused topk kernel: nd={nd} needs {smem1} bytes of shared memory, over "
            f"{_SMEM_LIMIT}")


def check_supported_q(x2, W2, b_enc, k: int, quant_block: int) -> None:
    """Raise :class:`ValueError` naming any shape or type the K3 kernel
    does not take: K2's operands and k, and a quant block that is a
    multiple of 32 dividing the contraction axis."""
    _check_operands(x2, W2, b_enc, "int8 fused topk")
    nd, width = W2.shape
    if not 0 < k <= min(_MAX_K, width):
        raise ValueError(f"int8 fused topk kernel takes 0 < k <= min({_MAX_K}, width={width}), "
                         f"got {k}")
    if quant_block <= 0 or quant_block % 32 or nd % quant_block:
        raise ValueError(f"int8 fused topk kernel takes a quant block that is a multiple of 32 "
                         f"dividing nd={nd}, got {quant_block}")


def _merge_group(k: int) -> int:
    """Tiles whose k candidates (and the k winners) one merge block stages
    in shared memory, 1 KB left for its static shared memory."""
    return ((_SMEM_LIMIT - 1024) // 8 - k) // k


def _candidates(B: int, width: int, k: int, dtype: torch.dtype, device):
    """The merge's scratch and outputs: ``(group, cand, cand2, vals, idx)``."""
    n_tiles = -(-width // _CW)
    group = min(n_tiles, _merge_group(k))
    cand = torch.empty((B, n_tiles, k), dtype=torch.int64, device=device)
    cand2 = torch.empty((B, -(-n_tiles // group) if group < n_tiles else 0, k),
                        dtype=torch.int64, device=device)
    vals = torch.empty((B, k), dtype=dtype, device=device)
    idx = torch.empty((B, k), dtype=torch.int32, device=device)
    return group, cand, cand2, vals, idx


def _check_cuda(x2: torch.Tensor, name: str) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {x2.device}")


def fused_topk_encode(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                      k: int, *, quant_block: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(vals [B, k] in x2.dtype, idx [B, k] int32)`` of the top-k of
    ``relu(cast(x2·W2 + b_enc))``, ascending index, ``(0, 0)``-padded.
    ``x2 [B, nd]`` and ``W2 [nd, width]`` in the compute dtype; ``b_enc``
    any float dtype, applied in fp32. ``quant_block > 0``: the int8
    block-scaled product (:func:`fused_topk_encode_q`). The plain version
    on CPU tensors, the Hopper kernel on CUDA tensors (or
    :class:`ValueError`; no fallback to the dense encode)."""
    if quant_block:
        return fused_topk_encode_q(x2, W2, b_enc, k, quant_block)
    if x2.device.type == "cpu":
        return fused_topk_encode_plain(x2, W2, b_enc, k)
    _check_cuda(x2, "fused_topk_encode")
    from crosscoder_tpu_torch.ops import _build

    x2 = x2.contiguous()
    W2 = W2.contiguous()
    check_supported(x2, W2, b_enc, k)
    B, nd = x2.shape
    width = W2.shape[1]
    b32 = b_enc.to(torch.float32).contiguous()
    group, cand, cand2, vals, idx = _candidates(B, width, k, x2.dtype, x2.device)
    code = _lib("fused_topk").fused_topk_launch(
        x2.data_ptr(), W2.data_ptr(), b32.data_ptr(), cand.data_ptr(), cand2.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), B, nd, width, k, group, int(x2.dtype == torch.bfloat16),
        _build.stream(x2.device),
    )
    _build.check(code, "fused topk kernel")
    fused_topk_encode.launches += 1
    return vals, idx


fused_topk_encode.launches = 0


def q_operands(x2: torch.Tensor, W2: torch.Tensor, quant_block: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's operands in the layouts its TMA loads read: ``(xq int8 [B, nd],
    xsT f32 [nb, Bp], wqT int8 [width, nd], ws f32 [nb, width])``, from
    :func:`quant.quantize_contraction`. Both int8 operands are K-major (the
    8-bit ``wgmma`` has no transpose); ``xsT`` holds ``xs`` transposed, so a
    block's scales of 128 rows are one contiguous row, zero-padded to
    ``Bp``, ``B`` rounded up to a multiple of 4 (16-byte TMA rows)."""
    xq, xs, wq, ws = quant.quantize_contraction(x2, W2, quant_block)
    B, nb = xs.shape
    xsT = torch.zeros((nb, -(-B // 4) * 4), dtype=torch.float32, device=xs.device)
    xsT[:, :B] = xs.t()
    # wq is the transposed view of the [width, nd] quantization: no copy
    return xq.contiguous(), xsT, wq.t().contiguous(), ws.contiguous()


def fused_topk_encode_q(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor, k: int,
                        quant_block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: :func:`fused_topk_encode` over the int8 block-scaled product
    (blocks of ``quant_block`` along the contraction). The operands are
    quantized first (:func:`q_operands`: K11 on the card); then the plain
    version on CPU tensors, the Hopper kernel on CUDA tensors (or
    :class:`ValueError`; no fallback)."""
    if x2.device.type == "cpu":
        return fused_topk_encode_q_plain(x2, W2, b_enc, k, quant_block)
    _check_cuda(x2, "fused_topk_encode_q")
    from crosscoder_tpu_torch.ops import _build

    check_supported_q(x2, W2, b_enc, k, quant_block)
    B, nd = x2.shape
    width = W2.shape[1]
    xq, xsT, wqT, ws = q_operands(x2, W2, quant_block)
    b32 = b_enc.to(torch.float32).contiguous()
    group, cand, cand2, vals, idx = _candidates(B, width, k, x2.dtype, x2.device)
    code = _lib("fused_topk_q").fused_topk_q_launch(
        xq.data_ptr(), xsT.data_ptr(), wqT.data_ptr(), ws.data_ptr(), b32.data_ptr(),
        cand.data_ptr(), cand2.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, xsT.shape[1], nd,
        width, k, quant_block, group, int(x2.dtype == torch.bfloat16), _build.stream(x2.device),
    )
    _build.check(code, "int8 fused topk kernel")
    fused_topk_encode_q.launches += 1
    return vals, idx


fused_topk_encode_q.launches = 0


# ---------------------------------------------------------------------------
# K4: fused BatchTopK


def batchtopk_budget(B: int, width: int, k: int) -> int:
    """``kk = min(k·B, B·width)``: the entries BatchTopK keeps, ties aside."""
    return min(k * B, B * width)


def fused_batchtopk_select_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                                 kk: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_batchtopk_select`."""
    return tp.batchtopk_select_plain(_pre_acts_plain(x2, W2, b_enc), kk)


def fused_batchtopk_emit_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                               kth: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_batchtopk_emit`."""
    return tp.batchtopk_emit_plain(_pre_acts_plain(x2, W2, b_enc), kth)


def fused_batchtopk_encode_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                                 k: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_batchtopk_encode`."""
    h = _pre_acts_plain(x2, W2, b_enc)
    kk = batchtopk_budget(*h.shape, k)
    return tp.batchtopk_emit_plain(h, tp.batchtopk_select_plain(h, kk))


def check_supported_bt(x2, W2, b_enc) -> None:
    """Raise :class:`ValueError` naming any shape or type the K4 kernels do
    not take: K2's operands, then bf16 the tensor-core tile's TMA gates,
    float32 a contraction axis divisible by 16 (its CUDA-core tile) and
    16-byte aligned operands."""
    _check_operands(x2, W2, b_enc, "fused batchtopk")
    if x2.dtype == torch.bfloat16:
        _check_tma(x2, W2, "fused batchtopk")
        return
    if x2.shape[1] % 16:
        raise ValueError(f"fused batchtopk kernel takes float32 nd divisible by 16, got "
                         f"nd={x2.shape[1]}")
    for name, t in (("x2", x2), ("W2", W2)):
        if t.data_ptr() % 16:
            raise ValueError(f"fused batchtopk kernel needs a 16-byte aligned {name}, got "
                             f"data_ptr % 16 = {t.data_ptr() % 16}")


def _bt_operands(x2, W2, b_enc, name: str):
    _check_cuda(x2, name)
    x2, W2 = x2.contiguous(), W2.contiguous()
    check_supported_bt(x2, W2, b_enc)
    return x2, W2, b_enc.to(torch.float32).contiguous()


def fused_batchtopk_select(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                           kk: int) -> torch.Tensor:
    """K4 select: the device int32 ``[1]`` pattern of the ``kk``-th largest
    clamped pattern of ``cast(x2·W2 + b_enc)`` (0 when fewer than ``kk``
    entries are positive), with no host sync. The plain version on CPU
    tensors, the kernel on CUDA tensors (or :class:`ValueError`)."""
    if x2.device.type == "cpu":
        return fused_batchtopk_select_plain(x2, W2, b_enc, kk)
    from crosscoder_tpu_torch.ops import _build

    x2, W2, b32 = _bt_operands(x2, W2, b_enc, "fused_batchtopk_select")
    if kk < 1:
        raise ValueError(f"fused_batchtopk_select takes kk >= 1, got {kk}")
    B, nd = x2.shape
    state = torch.zeros(_bt_state_bytes(), dtype=torch.uint8, device=x2.device)
    kth = torch.zeros(1, dtype=torch.int32, device=x2.device)
    code = _lib("fused_batchtopk").fused_bt_select(
        x2.data_ptr(), W2.data_ptr(), b32.data_ptr(), state.data_ptr(), kth.data_ptr(), B, nd,
        W2.shape[1], kk, int(x2.dtype == torch.bfloat16), _build.stream(x2.device))
    _build.check(code, "fused batchtopk select kernel")
    fused_batchtopk_select.launches += 1
    return kth


fused_batchtopk_select.launches = 0


def fused_batchtopk_emit(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                         kth: torch.Tensor) -> torch.Tensor:
    """K4 emit: ``[B, width]`` in x2.dtype, each entry of ``cast(x2·W2 +
    b_enc)`` whose clamped pattern is ``>= kth`` and ``> 0`` as the value of
    that pattern, zeros elsewhere (``kth`` a device int32 ``[1]``). The
    plain version on CPU tensors, the kernel on CUDA tensors (or
    :class:`ValueError`)."""
    if x2.device.type == "cpu":
        return fused_batchtopk_emit_plain(x2, W2, b_enc, kth)
    from crosscoder_tpu_torch.ops import _build

    x2, W2, b32 = _bt_operands(x2, W2, b_enc, "fused_batchtopk_emit")
    B, nd = x2.shape
    kth = kth.to(device=x2.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, W2.shape[1]), dtype=x2.dtype, device=x2.device)
    code = _lib("fused_batchtopk").fused_bt_emit(
        x2.data_ptr(), W2.data_ptr(), b32.data_ptr(), kth.data_ptr(), out.data_ptr(), B, nd,
        W2.shape[1], int(x2.dtype == torch.bfloat16), _build.stream(x2.device))
    _build.check(code, "fused batchtopk emit kernel")
    fused_batchtopk_emit.launches += 1
    return out


fused_batchtopk_emit.launches = 0


def fused_batchtopk_count_plain(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                                lo: int, hi: int, t: int = tp._BATCHTOPK_T) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_batchtopk_count`."""
    pats, _ = tp._bt_patterns(_pre_acts_plain(x2, W2, b_enc))
    return torch.stack([(pats >= m).sum() for m in tp.bisection_mids(lo, hi, t)])


def fused_batchtopk_count(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor, lo: int,
                          hi: int, t: int = tp._BATCHTOPK_T) -> torch.Tensor:
    """K4 count: int64 ``[t]``, the entries of ``cast(x2·W2 + b_enc)``
    whose clamped pattern (K9's rule) reaches each of one bisection pass's
    candidate patterns over ``[lo, hi)`` (:func:`topk_pallas.bisection_mids`),
    recomputing the product, with no host sync: one pass of the threshold
    over a rank grid, whose counts the caller sums over the ranks. The
    plain version on CPU tensors, the kernel on CUDA tensors (or
    :class:`ValueError`)."""
    if not (0 <= lo and hi - lo >= 2 and 1 <= t <= _MAX_MIDS):
        raise ValueError(f"fused_batchtopk_count takes 0 <= lo < hi - 1 and 1 <= t <= "
                         f"{_MAX_MIDS}, got lo={lo}, hi={hi}, t={t}")
    if x2.device.type == "cpu":
        return fused_batchtopk_count_plain(x2, W2, b_enc, lo, hi, t)
    from crosscoder_tpu_torch.ops import _build

    x2, W2, b32 = _bt_operands(x2, W2, b_enc, "fused_batchtopk_count")
    B, nd = x2.shape
    counts = torch.zeros(t, dtype=torch.int64, device=x2.device)
    code = _lib("fused_batchtopk").fused_bt_count(
        x2.data_ptr(), W2.data_ptr(), b32.data_ptr(), counts.data_ptr(), B, nd, W2.shape[1],
        lo, hi, t, int(x2.dtype == torch.bfloat16), _build.stream(x2.device))
    _build.check(code, "fused batchtopk count kernel")
    fused_batchtopk_count.launches += 1
    return counts


fused_batchtopk_count.launches = 0


def fused_batchtopk_encode(x2: torch.Tensor, W2: torch.Tensor, b_enc: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Fused ``batchtopk(cast(x2·W2 + b_enc), k)``: the masked ``[B,
    width]`` activations in x2.dtype, every entry at or above the ``min(k·B,
    B·width)``-th largest clamped pattern of the batch (all ties kept),
    without materialising the pre-activations to select. Non-differentiable
    (the model's autograd Function owns the straight-through gradient). K4
    select then emit on CUDA tensors (or :class:`ValueError`; no fallback to
    the dense encode), their plain versions on CPU tensors."""
    kk = batchtopk_budget(x2.shape[0], W2.shape[1], k)
    return fused_batchtopk_emit(x2, W2, b_enc, fused_batchtopk_select(x2, W2, b_enc, kk))

"""The gates of the fused encoder kernels (K2, K3, K4): the shapes, types and
alignments each kernel takes, checked on CPU tensors before any launch. A
shape a kernel does not take raises ValueError naming the dimension; the
wrappers never fall back to the plain version or the dense encode on the
card. bf16 runs the tensor-core tile, whose TMA loads need 16-byte rows
and operands; float32 keeps the CUDA-core kernels' own limits."""

import pytest
import torch

from crosscoder_tpu_torch.ops import fused_encoder_topk as fek


def _operands(B, nd, width, dtype, misalign=None):
    """Uninitialised operands (the gates read shapes and pointers only)."""
    x = torch.empty((B, nd), dtype=dtype)
    W = torch.empty((nd, width), dtype=dtype)
    if misalign == "x2":       # a contiguous view 2 elements into its storage
        x = torch.empty(B * nd + 2, dtype=dtype)[2:].view(B, nd)
    if misalign == "W2":
        W = torch.empty(nd * width + 2, dtype=dtype)[2:].view(nd, width)
    return x, W, torch.zeros(width)


@pytest.mark.parametrize("gate", ["topk", "batchtopk"])
@pytest.mark.parametrize("B,nd,width,misalign,match", [
    (4, 4100, 1024, None, "nd divisible by 8.*nd=4100"),
    (4, 4104 + 2, 1024, None, "nd divisible by 8.*nd=4106"),
    (4, 256, 1001, None, "width divisible by 8, got 1001"),
    (4, 256, 1024, "x2", "aligned x2"),
    (4, 256, 1024, "W2", "aligned W2"),
])
def test_bf16_tile_gates_name_the_dimension(gate, B, nd, width, misalign, match):
    x, W, b = _operands(B, nd, width, torch.bfloat16, misalign)
    with pytest.raises(ValueError, match=match):
        if gate == "topk":
            fek.check_supported(x, W, b, 32)
        else:
            fek.check_supported_bt(x, W, b)


@pytest.mark.parametrize("B,nd,width,k", [
    (1, 4104, 2 ** 15 + 8, 1), (3, 4104, 2 ** 15 + 8, 128), (130, 8, 8, 8),
    (4096, 4608, 2 ** 15, 32), (8, 4608, 2 ** 14, 32), (1, 2 ** 16, 1024, 32),
])
def test_bf16_tile_takes_edge_shapes(B, nd, width, k):
    """Rows, contraction and width that are not tile multiples are the
    tile's to mask; nd is not bounded by shared memory in bf16."""
    x, W, b = _operands(B, nd, width, torch.bfloat16)
    fek.check_supported(x, W, b, k)
    fek.check_supported_bt(x, W, b)


@pytest.mark.parametrize("k,match", [(0, "0 < k <= min"), (129, "0 < k <= min"),
                                     (2000, r"width=1024\), got 2000")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_topk_gate_bounds_k(dtype, k, match):
    x, W, b = _operands(4, 256, 1024, dtype)
    with pytest.raises(ValueError, match=match):
        fek.check_supported(x, W, b, k)


def test_f32_gates_keep_the_cuda_core_limits():
    x, W, b = _operands(4, 8192, 1024, torch.float32)
    with pytest.raises(ValueError, match="nd=8192 needs .* shared memory"):
        fek.check_supported(x, W, b, 32)
    x, W, b = _operands(4, 4104, 1024, torch.float32)
    fek.check_supported(x, W, b, 32)            # the SIMT K2 pass takes nd % 8 == 0
    with pytest.raises(ValueError, match="float32 nd divisible by 16.*nd=4104"):
        fek.check_supported_bt(x, W, b)
    x, W, b = _operands(4, 256, 1024, torch.float32, "W2")
    with pytest.raises(ValueError, match="aligned W2"):
        fek.check_supported_bt(x, W, b)


@pytest.mark.parametrize("fn", ["topk", "batchtopk"])
def test_gates_refuse_other_dtypes(fn):
    x, W, b = _operands(4, 256, 1024, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        if fn == "topk":
            fek.check_supported(x, W, b, 8)
        else:
            fek.check_supported_bt(x, W, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width,ok", [(1001, False), (1004, False), (1030, False),
                                      (8, True), (2 ** 15 + 8, True)])
def test_int8_gate_keeps_16_byte_scale_rows(dtype, width, ok):
    """K3 reads the W scales ``ws [nb, width]`` f32 by TMA, whose rows must
    be 16 bytes: the gate's width divisible by 8 covers that in both
    dtypes, so every width it takes launches the int8 tile."""
    x, W, b = _operands(4, 256, width, dtype)
    if ok:
        fek.check_supported_q(x, W, b, min(8, width), 128)
        return
    with pytest.raises(ValueError, match=f"width divisible by 8, got {width}"):
        fek.check_supported_q(x, W, b, 8, 128)

"""The port's block-scaled int8 quantization (crosscoder_tpu_torch/ops/quant.py)
against the JAX package's ops/quant.py on the same numpy inputs.

The JAX package gives two answers for the scale ``amax / 127``: compiled
(the jitted ``quantize_blocks``, which the buffer's quantize jits run, and
the Pallas kernel in interpret mode) XLA multiplies by the f32 reciprocal
of 127; eager ``quantize_blocks`` and numpy ``quantize_np`` divide. They
differ in the scale's last bit on a few percent of blocks (ROADMAP C3).
The port's ``quantize_blocks`` and ``quantize_rows`` follow the compiled
form, which is what the JAX buffer stores; its ``quantize_np`` is the JAX
numpy form and divides.

Bars: bitwise on the int8 payload and the f32 scales against the jitted
``quantize_blocks`` and the interpret-mode kernel, including half-way
quotients and all-zero blocks; the port's ``quantize_np`` bitwise against
JAX's; ``quantize_blocks`` against the eager and numpy paths, the
scales within one ulp and equal wherever JAX's own two forms agree, the
int8 equal except where that ulp carries a half-way quotient across, by
one. Dequantization is bitwise (one f32 multiply, one rounding). The K11
kernel itself is held against the port's plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.ops import quant as jquant
from crosscoder_tpu_torch.ops import quant

_jit_quantize = jax.jit(jquant.quantize_blocks, static_argnums=1)


@pytest.fixture
def _interpret():
    jquant.set_interpret(True)
    yield
    jquant.set_interpret(False)


def _planted(shape, block, seed):
    """Gaussian rows with an all-zero block, exact half-way quotients
    (amax 127 makes the scale 1, so k + 0.5 is a tie) and tiny values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 7.0).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0, :block] = 0.0
    flat[1, :block] = np.arange(block) % 20 - 9.5
    flat[1, 0] = 127.0
    flat[2, :block] *= 1e-30
    return x


def _np(a):
    return np.asarray(jax.device_get(a))


def _u32(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _assert_near_eager(q, s, x, jq, js, block):
    """``(q, s)`` against an eager/numpy JAX result ``(jq, js)``."""
    np.testing.assert_array_less(np.abs(s.view(np.int32).astype(np.int64)
                                        - js.view(np.int32)), 2)
    same = np.repeat(s == js, block, axis=-1)
    np.testing.assert_array_equal(q[same], jq[same])
    off = q != jq
    assert (np.abs(q.astype(int) - jq)[off] <= 1).all()
    quot = x / np.repeat(np.where(s > 0, s, 1), block, axis=-1)
    assert (np.abs(np.abs(quot - np.trunc(quot)) - 0.5)[off] < 1e-4).all()


@pytest.mark.parametrize("shape,block", [((33, 3, 128), 64), ((16, 2, 256), 256),
                                         ((5, 96), 32), ((4, 2, 64), 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_blocks_bitwise_equals_compiled_jax(shape, block, dtype):
    x = _planted(shape, block, sum(shape) + block)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    q, s = quant.quantize_blocks(xt, block)
    jq, js = (_np(a) for a in _jit_quantize(xj, block))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(_u32(s.numpy()), _u32(js))
    qr, sr = quant.quantize_rows(xt, block)              # CPU: the plain version
    assert torch.equal(q, qr) and torch.equal(s, sr)
    xf = np.asarray(xj.astype(jnp.float32))
    nq, ns = quant.quantize_np(xf, block)               # the numpy form divides, as JAX's
    jnq, jns = jquant.quantize_np(xf, block)
    np.testing.assert_array_equal(nq, jnq)
    np.testing.assert_array_equal(_u32(ns), _u32(jns))
    for eq, es in (jquant.quantize_blocks(xj, block), jquant.quantize_np(xf, block)):
        _assert_near_eager(q.numpy(), s.numpy(), xf, _np(eq), _np(es), block)


@pytest.mark.parametrize("rows,width,block", [(64, 256, 256), (256, 512, 128), (32, 2304, 256)])
def test_plain_quantize_rows_bitwise_equals_interpret_kernel(_interpret, rows, width, block):
    x = _planted((rows, width), block, rows + width)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    assert jquant.rows_supported(rows, width, block)
    jq, js = (_np(a) for a in jquant.quantize_rows(xb, block))
    q, s = quant.quantize_rows(torch.from_numpy(x).to(torch.bfloat16), block)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(_u32(s.numpy()), _u32(js))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequantize_bitwise_equals_jax(dtype):
    x = _planted((12, 2, 128), 32, 3)
    q, s = quant.quantize_np(x, 32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _np(jquant.dequantize_blocks(jnp.asarray(q), jnp.asarray(s), jdt))
    got = quant.dequantize_blocks(torch.from_numpy(q), torch.from_numpy(s), dtype)
    if dtype == torch.bfloat16:
        got_bits, view = got.view(torch.int16).numpy().view(np.uint16), np.uint16
    else:
        got_bits, view = got.numpy().view(np.uint32), np.uint32
    np.testing.assert_array_equal(got_bits, want.view(view))
    np.testing.assert_array_equal(quant.dequantize_np(q, s, want.dtype).view(view),
                                  want.view(view))
    assert (got.float()[0, 0, :32] == 0).all()          # the zero block


def test_roundtrip_error_bounded_and_zero_blocks_exact():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 2, 256)).astype(np.float32)
    x[3, 1, 64:96] = 0.0
    q, s = quant.quantize_blocks(torch.from_numpy(x), 32)
    deq = quant.dequantize_blocks(q, s, torch.float32).numpy()
    bound = np.repeat(s.numpy(), 32, axis=-1) / 2 + 1e-7
    assert (np.abs(deq - x) <= bound).all()
    assert (deq[3, 1, 64:96] == 0).all() and (s.numpy()[3, 1, 2] == 0)


def test_nan_and_inf_blocks_follow_jax():
    """A NaN makes its block's scale NaN and stores 0 for itself; an inf
    block has scale inf and stores 0 everywhere (x/inf, inf/inf -> NaN)."""
    x = np.ones((2, 256), np.float32)
    x[0, 0], x[1, 0] = np.nan, np.inf
    jq, js = _jit_quantize(jnp.asarray(x), 256)
    q, s = quant.quantize_blocks(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_array_equal(s.numpy(), _np(js))


def test_helpers_and_validation():
    assert quant.n_blocks(2304, 256) == 9
    with pytest.raises(ValueError, match="positive divisor"):
        quant.n_blocks(2304, 100)
    assert quant.store_bytes((10, 2, 256), 256) == jquant.store_bytes((10, 2, 256), 256)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        quant.quantize_rows(torch.zeros((2, 256), device="meta"), 256)

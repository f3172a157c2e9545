"""The port's fused encoder→TopK (crosscoder_tpu_torch/ops/fused_encoder_topk.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs: bitwise on integer-valued operands (exact fp32 sums in any
order) with planted ties, NaN and -0.0 and a dictionary width that is not
a tile multiple; allclose 1e-6 on random fp32. The Hopper kernel itself
is held against the plain version in test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek

B, ND, WIDTH = 12, 256, 2048 + 128


@pytest.fixture(autouse=True)
def _jax_kernels_plain():
    """Interpret mode is passed per call; keep the module switch off for
    whatever else shares this worker."""
    jfek.set_interpret(False)
    yield
    jfek.set_interpret(False)


def _planted(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(B, ND)).astype(np.float32)
    W = rng.integers(-2, 3, size=(ND, WIDTH)).astype(np.float32)
    b = rng.integers(-4, 5, size=(WIDTH,)).astype(np.float32)
    W[:, 600:640] = W[:, 10:50]          # duplicate columns: exact ties
    b[600:640] = b[10:50]
    W[:, WIDTH - 1] = W[:, 3]            # a tie across the tail tile
    b[WIDTH - 1] = b[3]
    x[1] = np.nan                        # NaN row: slots taken, nothing emitted
    x[2] = -0.0                          # -0.0 row
    b[700] = -0.0
    b[800] = np.nan                      # NaN column in every row
    x[3] = 0.0
    return x, W, b


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _torch_in(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("k", [1, 4, 32, 128])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_bitwise_matches_jax_kernel(k, dtype):
    x, W, b = _planted(k)
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    vals, idx = fek.fused_topk_encode(_torch_in(x, tdt), _torch_in(W, tdt),
                                      torch.from_numpy(b), k)
    jv, ji = jfek.fused_topk_encode(jnp.asarray(x, jdt), jnp.asarray(W, jdt),
                                    jnp.asarray(b), k, interpret=True)
    assert vals.dtype == tdt and idx.dtype == torch.int32 and vals.shape == (B, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    got = vals.view(torch.int16 if tdt == torch.bfloat16 else torch.int32).numpy()
    np.testing.assert_array_equal(got.view(_bits(jv).dtype), _bits(jv))
    # the NaN row emits nothing; the NaN column never appears
    assert not idx[1].any() and not (vals[1] != 0).any()
    assert not (idx == 800).any()


def test_plain_matches_jax_kernel_random_fp32():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, ND)).astype(np.float32)
    W = (rng.normal(size=(ND, WIDTH)) / 16).astype(np.float32)
    b = (rng.normal(size=(WIDTH,)) / 4).astype(np.float32)
    vals, idx = fek.fused_topk_encode(*(torch.from_numpy(a) for a in (x, W, b)), 32)
    jv, ji = jfek.fused_topk_encode(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), 32,
                                    interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)


def test_keys_and_emit_contract():
    """Ascending index, (0, 0) padding, lowest-index ties, the sign clamp."""
    h = torch.tensor([[2.0, -1.0, 2.0, float("nan"), -0.0, 5.0, float("inf"), 0.0]])
    keys = fek.select_keys(h)
    assert keys.tolist() == [[0x40000000, 0, 0x40000000, 0x7F800001, 0, 0x40A00000,
                              0x7F800000, 0]]
    vals, idx = fek.topk_from_keys(keys, 4, torch.float32)
    # best four: NaN (dropped at emit), inf, 5.0, 2.0 at the lower index 0
    assert idx.tolist() == [[0, 5, 6, 0]]
    assert vals.tolist() == [[2.0, 5.0, float("inf"), 0.0]]


def test_kernel_rejects_unsupported_shapes():
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError, match="k <="):
        fek.check_supported(x, torch.zeros(256, 1024), torch.zeros(1024), 129)
    with pytest.raises(ValueError, match="divisible by 8"):
        fek.check_supported(x, torch.zeros(256, 1001), torch.zeros(1001), 32)
    with pytest.raises(ValueError, match="shared memory"):
        fek.check_supported(torch.zeros(4, 8192), torch.zeros(8192, 1024),
                            torch.zeros(1024), 32)
    fek.check_supported(x.bfloat16(), torch.zeros(256, 1024).bfloat16(), torch.zeros(1024), 32)


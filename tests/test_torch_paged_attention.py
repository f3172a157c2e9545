"""The port's ragged paged attention (crosscoder_tpu_torch/ops/paged_attention.py)
against the JAX package's: its plain version vs the Pallas kernel run in
interpret mode and vs the JAX reference, on the same numpy inputs, at atol
1e-5 in fp32 on valid rows; and the page pool layout. The Hopper kernel
itself is held against the plain version in test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu_torch.ops import paged_attention as pa

D, S, H, KV, HD = 4, 16, 4, 2, 8          # g = 2
SCALE = 0.35
LENGTHS = np.array([1, 16, 7, 9], np.int32)   # single-token and full-length docs
TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_kernels_plain():
    """Interpret mode is passed per call; keep the module switch off for
    whatever else shares this worker."""
    jpa.set_interpret(False)
    yield
    jpa.set_interpret(False)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(D, S, H, HD)).astype(np.float32),
            rng.normal(size=(D, S, KV, HD)).astype(np.float32),
            rng.normal(size=(D, S, KV, HD)).astype(np.float32))


def _valid_close(got, want):
    for d, ln in enumerate(LENGTHS):
        np.testing.assert_allclose(got[d, :ln], want[d, :ln], rtol=TOL, atol=TOL,
                                   err_msg=f"doc {d}")


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 50.0), (0, 50.0), (8, 0.0)])
def test_plain_matches_jax_kernel_and_reference(qkv, window, softcap, page):
    q, k, v = qkv
    got = pa.paged_attention(
        *(torch.from_numpy(a) for a in qkv), torch.from_numpy(LENGTHS),
        page_size=page, scale=SCALE, softcap=softcap, window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in qkv)
    kernel = np.asarray(jpa.paged_attention(
        jq, jk, jv, jnp.asarray(LENGTHS), page_size=page, scale=SCALE,
        softcap=softcap, window=window, interpret=True))
    ref = np.asarray(jpa.ragged_attention_reference(
        jq, jk, jv, jnp.asarray(LENGTHS), scale=SCALE, softcap=softcap,
        window=window, is_local=bool(window)))
    assert got.shape == (D, S, H * HD)
    _valid_close(got, kernel)
    _valid_close(got, ref)


def test_padded_reference_matches_jax(qkv):
    """lengths=None (the padded forward) and a non-local layer."""
    got = pa.ragged_attention_reference(
        *(torch.from_numpy(a) for a in qkv), None, scale=SCALE, softcap=50.0,
        window=8, is_local=False).numpy()
    want = np.asarray(jpa.ragged_attention_reference(
        *(jnp.asarray(a) for a in qkv), None, scale=SCALE, softcap=50.0,
        window=8, is_local=False))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_paginate_kv_matches_jax(qkv):
    _, k, v = qkv
    pages, tbl = pa.paginate_kv(torch.from_numpy(k), torch.from_numpy(v), 4)
    jpages, jtbl = jpa.paginate_kv(jnp.asarray(k), jnp.asarray(v), 4)
    np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
    np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    assert tbl.dtype == torch.int32
    with pytest.raises(ValueError, match="not divisible"):
        pa.paginate_kv(torch.from_numpy(k), torch.from_numpy(v), 3)


def test_kernel_rejects_unsupported_shapes():
    """Shapes the Hopper kernel does not take raise ValueError by name
    (checked before any launch, so this runs without a card)."""
    q = torch.zeros(2, 64, 4, 8)
    kv = torch.zeros(2, 64, 2, 8)
    with pytest.raises(ValueError, match="head_dim"):
        pa.check_supported(q, kv, kv, torch.ones(2), 64)
    q = torch.zeros(2, 64, 4, 128)
    kv = torch.zeros(2, 64, 2, 128)
    with pytest.raises(ValueError, match="page_size"):
        pa.check_supported(q, kv, kv, torch.ones(2), 16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pa.check_supported(q.half(), kv.half(), kv.half(), torch.ones(2), 64)
    pa.check_supported(q, kv, kv, torch.ones(2), 32)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores"), (torch.float16, None)])
def test_kernel_route_by_dtype(dtype, route):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one (a
    dispatch by dtype, no fallback); another dtype raises. A CPU call runs
    the plain version and counts no launch on either route."""
    if route is None:
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            pa.kernel_route(dtype)
        return
    assert pa.kernel_route(dtype) == route
    before = (pa.paged_attention.launches, pa.paged_attention.last_route,
              dict(pa.paged_attention.by_route))
    q = torch.zeros(1, 64, 2, 128, dtype=dtype)
    kv = torch.zeros(1, 64, 1, 128, dtype=dtype)
    out = pa.paged_attention(q, kv, kv, torch.tensor([5]), page_size=32, scale=1.0)
    assert out.shape == (1, 64, 256) and out.dtype == dtype
    assert (pa.paged_attention.launches, pa.paged_attention.last_route,
            pa.paged_attention.by_route) == before

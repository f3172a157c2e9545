"""The plain model of the row TopK masks' on-chip design (K5, and K7's
cluster route: a row cut into slices, one a block of a thread-block
cluster, ``topk_pallas.topk_sliced_plain``) against the plain versions
and against the JAX kernels they replace, run in interpret mode; and the
launch plan of K7 (``topk_pallas.topk_plan``) at each of its route
boundaries.

Bars: bitwise against ``topk_chunked_plain`` (K7's function) and
``topk_plain`` (K5's and K6's) everywhere. Against JAX: f32 bitwise
everywhere; bf16 bitwise except the NaN entries of ROADMAP C1, where the
port writes the clamped pattern 0x7FFE (K5's rule) and the interpreter its
canonical NaN: both are NaN and select the same columns."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch.ops import topk_pallas as tp

R = 13


def _planted(seed, W, n_slices, dtype):
    """Integer-valued rows: ties wider than k, ties at 9 and a wide run of
    ties at 7 straddling every slice edge (so the kept ties of row 4 span
    slices), rows with fewer than k positives, -0.0, +inf, NaN of both
    signs (bf16: one NaN a row, as ROADMAP C1 needs), and (f32) a NaN
    beside +inf among a row's top k (ROADMAP C6)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-6, 7, size=(R, W)).astype(np.float32)
    S = tp._slice_cols(W, n_slices)
    edges = list(range(S, W, S)) or [W // 2]
    h[0, : W // 2] = 5.0
    h[1] = -1.0
    h[1, 7] = 2.0
    h[2] = -0.0
    h[3, W - 2] = 9.0
    for e in edges:
        h[3, max(e - 3, 0): e + 3] = 9.0
        h[4, max(e - 20, 0): e + 20] = 7.0
    h[5, 11] = np.inf
    h[5, W - 1] = np.inf
    h[9, W - 40:] = 8.0
    if dtype == torch.float32:
        u = h.view(np.uint32)
        u[6, 13] = 0x7FC00001
        u[7, :] = 0xFFC00000                        # a row of negative NaNs
        u[7, 3] = 0x40000000
        u[8, 5] = 0xFFC00000
        u[8, 6] = 0x7FC00001
        u[10, 5] = 0x7FC00001
        h[10, 6] = np.inf
        return torch.from_numpy(h)
    b = torch.from_numpy(h).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16).copy()
    b[6, 13] = 0x7FFF
    b[7, :] = 0x3F80                                # 1.0 everywhere
    b[7, 3] = 0xFFC1                                # a negative NaN: kept, above +inf
    b[8, :] = 0xBF80
    b[8, 5] = 0xFFFF
    b[10, 5] = 0x4000
    b[10, 6] = 0x7F80
    return torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W", [1000, 4096, 8192 + 8])
@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 32, "W"])
def test_sliced_plain_bitwise_equals_the_plain_versions(dtype, W, n_slices, k):
    k = W if k == "W" else k
    h = _planted(W + n_slices + k, W, n_slices, dtype)
    got = tp.topk_sliced_plain(h, k, n_slices, tp._CHUNKED_TOP[dtype])
    assert torch.equal(_bits(got), _bits(tp.topk_chunked_plain(h, k)))
    assert torch.equal(_bits(tp.topk_sliced_plain(h, k, n_slices, None)),
                       _bits(tp.topk_plain(h, k)))
    kept = (got != 0).sum(1)
    if k == 32:
        assert int(kept[4]) == 32                   # the ties at 7 span slices and are cut
        assert int(kept[1]) == 1                    # fewer than k positives: all kept


@functools.cache
def _jax(dtype, W, n_slices, k, chunked):
    """The JAX kernel's output bits on the planted rows: ``jtp.topk`` in
    interpret mode (its own dispatch), or the width-chunked kernels
    directly (``chunked``)."""
    h = _planted(W + n_slices + k, W, n_slices, dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    hj = jnp.asarray(_bits(h).numpy()).view(jdt)
    out = jtp._topk_chunked_impl(hj, k, True) if chunked else jtp.topk(hj, k, interpret=True)
    view = np.uint16 if dtype == torch.bfloat16 else np.uint32
    return h, np.asarray(out.view(jnp.uint16 if dtype == torch.bfloat16 else jnp.uint32)).view(view)


def _holds_against_jax(got, want, dtype):
    view = np.uint16 if dtype == torch.bfloat16 else np.uint32
    got = _bits(got).numpy().view(view)
    if dtype == torch.float32:
        np.testing.assert_array_equal(got, want)
        return
    nan = (want & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(got[~nan], want[~nan])
    np.testing.assert_array_equal(got[nan] != 0, want[nan] != 0)
    assert (got[nan & (got != 0)] == 0x7FFE).all()


@pytest.mark.parametrize("dtype,W,jax_kernel", [
    (torch.float32, 32768, "chunked"),              # past the single-block gate
    (torch.float32, 1024, "single"),
    (torch.bfloat16, 8192, "composite")])
@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 32])
def test_sliced_plain_equals_jax_topk(dtype, W, jax_kernel, n_slices, k):
    itemsize = 2 if dtype == torch.bfloat16 else 4
    probe = jnp.zeros((1, W), jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    assert {"chunked": not jtp._single_block_supported(W, k, itemsize)
            and jtp._chunked_supported(W, k),
            "single": jtp._single_block_supported(W, k, itemsize) and dtype == torch.float32,
            "composite": jtp._composite_supported(probe, k)}[jax_kernel]
    h, want = _jax(dtype, W, n_slices, k, False)
    top = tp._CHUNKED_TOP[dtype] if jax_kernel == "chunked" else None
    _holds_against_jax(tp.topk_sliced_plain(h, k, n_slices, top), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_slices", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 32])
def test_sliced_plain_equals_jax_chunked_kernels(dtype, n_slices, k):
    """The JAX width-chunked kernels at their smallest width (two 4096
    chunks), what K7 replaces for bf16 above 2^16 and f32 past the
    single-block gate."""
    W = 8192
    assert jtp._chunked_supported(W, k)
    h, want = _jax(dtype, W, n_slices, k, True)
    _holds_against_jax(tp.topk_sliced_plain(h, k, n_slices, tp._CHUNKED_TOP[dtype]), want, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", range(1, tp._MAX_CLUSTER + 1))
def test_topk_plan_at_each_route_boundary(dtype, C):
    """At the widest row a cluster of C blocks takes, and 8 columns past
    it (C + 1 blocks, or the streaming route past 8); the plan's slicing
    run through the plain model equals the plain version there."""
    itemsize = 2 if dtype == torch.bfloat16 else 4
    per = tp._SLICE_BYTES // itemsize
    assert tp.topk_plan(C * per, dtype) == ("cluster", C, per)
    past = tp.topk_plan(C * per + 8, dtype)
    if C == tp._MAX_CLUSTER:
        assert past == ("streaming", 0, 0)
    else:
        assert past[:2] == ("cluster", C + 1)
    for W in (C * per, C * per + 8):
        route, n, S = tp.topk_plan(W, dtype)
        if route == "cluster":
            assert S % 8 == 0 and S * itemsize <= tp._SLICE_BYTES
            assert (n - 1) * S < W <= n * S
        rng = np.random.default_rng(C)
        h = torch.from_numpy(rng.integers(-6, 7, size=(3, W)).astype(np.float32)).to(dtype)
        h[0, :: 3] = 6.0                                            # ties across every slice
        ref = tp.topk_chunked_plain(h, 32)
        got = tp.topk_sliced_plain(h, 32, max(n, 1), tp._CHUNKED_TOP[dtype])
        assert torch.equal(_bits(got), _bits(ref))


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing():
    h = _planted(5, 2 ** 17, 4, torch.bfloat16)
    before = (tp.topk_chunked.launches, dict(tp.topk_chunked.by_route), tp.topk.launches)
    assert torch.equal(_bits(tp.topk_chunked(h, 32)), _bits(tp.topk_chunked_plain(h, 32)))
    assert torch.equal(_bits(tp.topk_mask(h[:, :4096], 32)),
                       _bits(tp.topk_plain(h[:, :4096], 32)))
    assert (tp.topk_chunked.launches, tp.topk_chunked.by_route, tp.topk.launches) == before
    assert set(tp.topk_chunked.by_route) == {"cluster", "streaming"}

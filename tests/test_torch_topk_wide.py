"""The plain versions of the port's f32 TopK mask (K6) and width-chunked
TopK (K7) against the JAX kernels they replace, run in interpret mode
(crosscoder_tpu/ops/topk_pallas.py ``_topk_mask_kernel`` and
``_bisect_kernel``/``_emit_kernel`` through ``_topk_chunked_impl``), the
straight-through gradient, and the dispatch table.

Bars: f32 bitwise everywhere, NaN of both signs included (the CPU
interpreter's ``maximum(x, 0)`` keeps an f32 NaN's sign and payload: a
negative NaN is never kept, a positive one ranks by its pattern). bf16
bitwise except the NaN entries of ROADMAP C1: there the port writes the
clamped pattern 0x7FFE (K5's rule) where the interpreter writes its
canonical NaN; both are NaN and select the same columns. The gradient is
exact (a select, no arithmetic)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import topk_pallas

F32_NAN, F32_NEG_NAN = 0x7FC00001, 0xFFC00000


def _planted_f32(seed, R, W):
    """Integer-valued rows: ties wider than k, ties across any chunk
    boundary, rows with fewer than k positives, -0.0, +inf, NaN of both
    signs (one positive NaN a row, so no row ranks two NaN payloads)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-6, 7, size=(R, W)).astype(np.float32)
    h[0, : W // 2] = 5.0
    h[1] = -1.0
    h[1, 7] = 2.0
    h[2] = -0.0
    h[3, W // 4 - 3: W // 4 + 3] = 9.0                 # a tie straddling a chunk edge
    h[3, W - 2] = 9.0
    h[4] = 0.0
    h[5, 11] = np.inf
    h[5, W - 1] = np.inf
    u = h.view(np.uint32)
    u[6, 13] = F32_NAN
    u[7, :] = F32_NEG_NAN                               # a row of negative NaNs
    u[7, 3] = 0x40000000
    u[8, 5] = F32_NEG_NAN
    u[8, 6] = F32_NAN
    h[9, W - 40:] = 8.0                                 # ties far from the kth column
    return h


def _planted_bf16(seed, R, W):
    """As :func:`_planted_f32` in bf16; NaN only as one entry a row (the
    widest payload 0x7FFF, or a negative NaN), so both NaN rules pick the
    same columns."""
    h = np.asarray(jnp.asarray(_planted_f32(seed, R, W)[:, :], jnp.bfloat16).view(jnp.uint16))
    h = h.copy()
    h[6, :] = np.asarray(jnp.asarray(np.where(np.arange(W) % 3 == 0, 1.0, -2.0), jnp.bfloat16)
                         .view(jnp.uint16))
    h[6, 13] = 0x7FFF
    h[7, :] = 0x3F80                                    # 1.0 everywhere
    h[7, 3] = 0xFFC1
    h[8, :] = 0xBF80
    h[8, 5] = 0xFFFF
    return h


def _f32_bits(t):
    return t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("width", [256, 384, 1024])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_k6_plain_bitwise_equals_jax_single_block_kernel(width, k):
    h = _planted_f32(width + k, 20, width)
    assert topk_pallas.topk_route(width, k, torch.float32) == "K6"
    want = np.asarray(jtp.topk(jnp.asarray(h), k, interpret=True)).view(np.uint32)
    got = topk_pallas.topk(torch.from_numpy(h), k)
    np.testing.assert_array_equal(_f32_bits(got), want)
    np.testing.assert_array_equal(_f32_bits(topk_pallas.topk_mask_f32(torch.from_numpy(h), k)),
                                  want)
    assert np.isnan(got.numpy()[6, 13]) and got.numpy()[7, 3] == 2.0 and not got.numpy()[8, 5]


@pytest.mark.parametrize("cw", [128, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_k7_plain_f32_bitwise_equals_jax_chunked_kernel(cw, k):
    W = 4 * cw
    h = _planted_f32(cw + k, 37, W)                     # 37 rows: the JAX side pads to 64
    want = np.asarray(jtp._topk_chunked_impl(jnp.asarray(h), k, True, chunk_width=cw))
    got = topk_pallas.topk_chunked(torch.from_numpy(h), k)
    np.testing.assert_array_equal(_f32_bits(got), want.view(np.uint32))
    assert ((got.numpy() != 0).sum(1) <= k + 1).all()


@pytest.mark.parametrize("cw", [128, 256])
@pytest.mark.parametrize("k", [1, 4, 32])
def test_k7_plain_bf16_equals_jax_chunked_kernel_on_patterns(cw, k):
    W = 4 * cw
    bits = _planted_bf16(cw + k, 37, W)
    want = np.asarray(jtp._topk_chunked_impl(jnp.asarray(bits).view(jnp.bfloat16), k, True,
                                             chunk_width=cw).view(jnp.uint16))
    ht = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    got = topk_pallas.topk_chunked(ht, k).view(torch.int16).numpy().astype(np.uint16)
    nan = (bits & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(got[~nan], want[~nan])
    np.testing.assert_array_equal(got[nan] != 0, want[nan] != 0)
    assert (want[nan] != 0).sum() == 3
    assert (got[nan & (got != 0)] == 0x7FFE).all()
    # bf16 K7 is K5's function
    np.testing.assert_array_equal(got, topk_pallas.topk_plain(ht, k).view(torch.int16).numpy()
                                  .astype(np.uint16))


def test_jax_k6_and_k7_disagree_where_nan_sits_above_inf():
    """ROADMAP C6: the JAX chunked kernel bisects f32 patterns below
    0x7F800001 and takes count(>= that) as 0, so a row whose top k holds a
    NaN keeps every NaN plus up to k entries at +inf; the single-block
    kernel keeps exactly k. Each port plain version follows its kernel."""
    W = 512
    h = np.tile((np.arange(W) % 50).astype(np.float32) / 8, (32, 1))
    h[0, [10, 20]] = np.inf
    h[0, 30] = np.nan
    h[1, 10] = np.inf
    h[1, [30, 40]] = np.nan
    k6 = np.asarray(jtp.topk(jnp.asarray(h), 1, interpret=True))
    k7 = np.asarray(jtp._topk_chunked_impl(jnp.asarray(h), 1, True, chunk_width=128))
    assert [list(np.nonzero(r)[0]) for r in k6[:2]] == [[30], [30]]
    assert [list(np.nonzero(r)[0]) for r in k7[:2]] == [[10, 30], [10, 30, 40]]
    t = torch.from_numpy(h)
    np.testing.assert_array_equal(_f32_bits(topk_pallas.topk_plain(t, 1)), k6.view(np.uint32))
    np.testing.assert_array_equal(_f32_bits(topk_pallas.topk_chunked_plain(t, 1)),
                                  k7.view(np.uint32))
    np.testing.assert_array_equal(k6[2:], k7[2:])


@pytest.mark.parametrize("width,route", [(512, "K6"), (32768, "K7")])
def test_topk_gradient_is_jax_straight_through(width, route):
    h = _planted_f32(width, 12, width)
    h[6, 13] = 3.5                                       # finite, so the gradient is too
    h[8, 6] = 4.5
    g = np.random.default_rng(1).standard_normal(h.shape).astype(np.float32)
    assert topk_pallas.topk_route(width, 8, torch.float32) == route
    want = jax.grad(lambda x: jnp.sum(jtp.topk(x, 8, interpret=True) * g))(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    (topk_pallas.topk(ht, 8) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ht.grad.numpy(), np.asarray(want))


def _jax_choice(width, k, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    probe = jax.ShapeDtypeStruct((1, width), jdt)
    if jtp._composite_supported(probe, k):
        return "composite"
    if jtp._single_block_supported(width, k, jnp.dtype(jdt).itemsize):
        return "single"
    if jtp._chunked_supported(width, k):
        return "chunked"
    return "dense"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_table_follows_jax(dtype):
    widths = [96, 256, 384, 1000, 1920, 8192, 16384, 26624, 26752, 28672, 32768, 65536,
              65536 + 384, 1 << 17, 3 * (1 << 16)]
    seen = set()
    for width in widths:
        for k in sorted({kk for kk in (1, 32, 128, width - 1, width) if kk <= width}):
            choice = _jax_choice(width, k, dtype)
            route = topk_pallas.topk_route(width, k, dtype)
            seen.add((choice, route))
            want = {"composite": "K5", "single": "K6", "chunked": "K7"}.get(choice)
            if want is not None:
                assert route == want, (width, k, choice, route)
            else:                                       # JAX's lax.top_k: the same mask
                assert route == ("K5" if dtype == torch.bfloat16 and width <= 1 << 16 else "K7")
            assert topk_pallas.supported(width, k, dtype) == (choice != "dense")
    if dtype == torch.float32:
        assert {("single", "K6"), ("chunked", "K7"), ("dense", "K7")} <= seen
    else:
        assert {("composite", "K5"), ("chunked", "K7"), ("dense", "K5")} <= seen
    for bad in ((512, 0), (512, 513)):
        with pytest.raises(ValueError, match="0 < k <= width"):
            topk_pallas.topk_route(*bad, dtype)
    with pytest.raises(ValueError, match="bf16 or f32"):
        topk_pallas.topk_route(512, 4, torch.float16)


def test_cpu_dispatch_runs_each_routes_plain_version():
    h = torch.from_numpy(_planted_f32(3, 12, 32768))
    h[0, 5] = float("nan")
    h[0, 6] = float("inf")
    want = topk_pallas.topk_chunked_plain(h, 1)
    assert torch.equal(topk_pallas.topk(h, 1).view(torch.int32), want.view(torch.int32))
    assert int((want[0] != 0).sum()) == 2                # C6: the NaN and the +inf
    assert not torch.equal(want.view(torch.int32), topk_pallas.topk_plain(h, 1).view(torch.int32))


@pytest.mark.parametrize("enc_dtype,dict_size,sparse_bwd", [
    ("fp32", 2 ** 14, "on"), ("fp32", 2 ** 15, "on"), ("fp32", 2 ** 15, "auto"),
    ("bf16", 2 ** 17, "auto"), ("bf16", 2 ** 17, "off"), ("fp32", 2 ** 14, "auto")])
def test_factored_gate_resolves_as_jax(enc_dtype, dict_size, sparse_bwd):
    kw = dict(d_in=2304, dict_size=dict_size, activation="topk", topk_k=32, l1_coeff=0.0,
              enc_dtype=enc_dtype, sparse_bwd=sparse_bwd)
    jtp.set_interpret(True)
    try:
        want = jcc.use_factored_decode(JCfg(**kw))
    finally:
        jtp.set_interpret(False)
    assert cc.use_factored_decode(CrossCoderConfig(**kw)) == want
    assert want == (dict_size >= 2 ** 17 or sparse_bwd == "on")

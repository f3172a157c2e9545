"""The plain models of the port's sparsify drain (K8) and int8 row quantize
(K11) routes against the JAX package's functions they replace.

K8's split route cuts a row into parts, drains each alone and places the
parts' entries by a prefix sum of their counts (``sparsify_split_plain``,
the parts a parameter): bitwise equal to ``sparsify_plain`` and to the
JAX ``topk_pallas.sparsify`` in interpret mode for 1 to 8 parts, on bf16
and f32 rows with fewer than k, exactly k and more than k positives (the
last one in each part), -0.0, NaN, +inf and negatives. K11's column route
quantizes a transposed view where it lies: ``quant.quantize_rows`` on
``W.t()`` bitwise equal to the same call on ``W.t().contiguous()`` and to
the jitted JAX ``quant.quantize_blocks(W.T, block)`` (jitted, so that both
multiply by fl(1/127); ROADMAP C3), on all-zero blocks, half-way quotients
and NaN (a NaN scale compared as NaN, whatever its payload); and
``quantize_contraction`` bitwise to the jitted JAX
``_quantize_contraction``. The kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels_cuda.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import quant as jquant
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch.ops import quant, topk_pallas

_jit_quantize = jax.jit(jquant.quantize_blocks, static_argnums=1)
_jit_contraction = jax.jit(jfek._quantize_contraction, static_argnums=2)


def _drain_rows(seed, width, k):
    """f32 rows: none positive; fewer than k; exactly k; k + 3 positives
    with the last in each eighth of the row (so in each part of any
    split); -0.0, NaN, +inf and negatives; random sparse rows."""
    rng = np.random.default_rng(seed)
    f = np.where(rng.random((24, width)) < 0.02, rng.normal(size=(24, width)), 0.0)
    f = f.astype(np.float32)
    f[0] = -1.0
    f[1] = 0.0
    f[1, rng.choice(width, size=min(width, max(k // 2, 1)), replace=False)] = 3.0
    f[2] = -2.0
    f[2, rng.choice(width, size=min(width, k), replace=False)] = rng.integers(1, 9, min(width, k))
    for i in range(8):
        end = max(1, (i + 1) * width // 8)
        r = 3 + i
        f[r] = 0.0
        cols = rng.choice(end, size=min(end, k + 3), replace=False)
        f[r, cols] = rng.integers(1, 9, size=cols.size)
        f[r, end - 1] = 4.0                        # the last positive closes eighth i
    f[11, 1:5] = [-0.0, np.nan, np.inf, -np.inf]
    f[12, ::3] = 2.0                               # a row far past k
    return f


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("width", [64, 250, 1000, 2056])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_sparsify_split_plain_matches_plain_and_jax(dtype, width, k):
    f = _drain_rows(width + k, width, k)
    ft = torch.from_numpy(f)
    ft = ft.to(torch.bfloat16) if dtype == "bf16" else ft
    vals, idx = topk_pallas.sparsify_plain(ft, k)
    vj, ij = jtp.sparsify(jnp.asarray(f, jnp.bfloat16 if dtype == "bf16" else jnp.float32), k,
                          interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(vals).numpy(),
                                  np.asarray(vj).view(np.int16 if dtype == "bf16" else np.int32))
    for parts in range(1, 9):
        sv, si = topk_pallas.sparsify_split_plain(ft, k, parts)
        assert torch.equal(si, idx), parts
        assert torch.equal(_bits(sv), _bits(vals)), parts


@pytest.mark.parametrize("width", [8, 2 ** 14, 2 ** 15, 2 ** 17, 2 ** 15 + 8, 2 ** 17 + 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [1, 2, 32, 512, 513])
def test_sparsify_plan_parts_cover_the_row(width, dtype, k):
    """The split route takes 2, 4 or 8 parts of 8-aligned columns that
    cover the row, each of at least ``_PART_BYTES``, only for 2 <= k <=
    ``_SPLIT_MAX_K``; every other row takes the warp route."""
    route, parts, cols = topk_pallas.sparsify_plan(width, k, dtype)
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if route == "warp":
        assert (parts, cols) == (1, width)
        assert (width * itemsize < 2 * topk_pallas._PART_BYTES
                or not 2 <= k <= topk_pallas._SPLIT_MAX_K)
    else:
        assert route == "split" and parts in (2, 4, 8) and 2 <= k <= topk_pallas._SPLIT_MAX_K
        assert cols % 8 == 0 and parts * cols >= width > (parts - 1) * cols
        assert width * itemsize // parts >= topk_pallas._PART_BYTES


def test_sparsify_plan_takes_the_split_route_on_the_main_shapes():
    """The training paths' K8 shapes (k 32) take the split route; k 1 and
    k past the staging limit take the warp route."""
    for width, dt in ((2 ** 15, torch.bfloat16), (2 ** 17, torch.bfloat16),
                      (2 ** 14, torch.float32), (2 ** 15, torch.float32)):
        assert topk_pallas.sparsify_plan(width, 32, dt)[0] == "split"
        assert topk_pallas.sparsify_plan(width, 1, dt)[0] == "warp"
        assert topk_pallas.sparsify_plan(width, topk_pallas._SPLIT_MAX_K + 1, dt)[0] == "warp"


def _planted_w(seed, d, R, block):
    """A [d, R] weight whose columns, read as rows of W.T, hold an
    all-zero block, a block of exact half-way quotients (max 127: scale
    1) and a NaN."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d, R)) * 7).astype(np.float32)
    w[:block, 0] = 0.0
    w[:block, 1] = np.arange(block) % 20 - 9.5
    w[0, 1] = 127.0
    w[block + 3, 2] = np.nan
    return w


def _same_scales(a, b):
    """Bitwise, a NaN scale against a NaN scale whatever their payloads."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a).view(np.int32), np.nan_to_num(b).view(np.int32))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("block", [32, 128, 256])
@pytest.mark.parametrize("R", [1, 77, 130])
def test_quantize_rows_of_a_transposed_view_bitwise(dtype, block, R):
    w = _planted_w(block + R, 512, max(R, 3), block)[:, :R]
    wt = torch.from_numpy(np.ascontiguousarray(w))
    wt = wt.to(torch.bfloat16) if dtype == "bf16" else wt
    view = wt.t()
    assert quant.quantize_route(view) == ("column" if R > 1 else "row")
    q, s = quant.quantize_rows(view, block)
    cq, cs = quant.quantize_rows(view.contiguous(), block)
    assert torch.equal(q, cq)
    _same_scales(s.numpy(), cs.numpy())
    jq, js = _jit_quantize(jnp.asarray(w, jnp.bfloat16 if dtype == "bf16" else jnp.float32).T,
                           block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _same_scales(s.numpy(), np.asarray(js))


def test_quantize_route_takes_the_column_route_only_for_transposed_views():
    w = torch.zeros((64, 48))
    assert quant.quantize_route(w) == "row"
    assert quant.quantize_route(w.t()) == "column"
    assert quant.quantize_route(w[:, :16].t()) == "column"           # a slice's view: ld > R
    assert quant.quantize_route(w[:, ::2]) == "row"                   # strided rows: copied
    assert quant.quantize_route(w.t()[:, ::2]) == "column"           # every other source row
    assert quant.quantize_route(torch.zeros((4, 8, 3)).transpose(1, 2)) == "row"


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("block", [32, 128, 256])
def test_quantize_contraction_bitwise_equals_jitted_jax(dtype, block):
    rng = np.random.default_rng(block)
    x = (rng.normal(size=(37, 512)) * 3).astype(np.float32)
    x[0, :block] = 0.0
    w = _planted_w(block, 512, 200, block)
    w[block + 3, 2] = 1.0                          # no NaN: the fused encoder's operands
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if dtype == "bf16" else (torch.float32, jnp.float32)
    got = quant.quantize_contraction(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                     block)
    want = _jit_contraction(jnp.asarray(x, jdt), jnp.asarray(w, jdt), block)
    for g, j in zip(got, want):
        assert tuple(g.shape) == j.shape
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        else:
            np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(j).view(np.int32))

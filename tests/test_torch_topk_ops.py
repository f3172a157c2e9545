"""The plain versions of the port's TopK mask (K5), sparsify drain (K8) and
sorted-pair scatter (K10) against the JAX kernels they replace, run in
interpret mode (crosscoder_tpu/ops/topk_pallas.py, ops/sparse_grad.py).

Bars: the mask and the drain are bitwise equal on bf16 rows with planted
ties, NaN of both signs and -0.0 (the f32 mask bitwise on ties and -0.0;
NaN order among f32 rows is outside the JAX contract). One exception,
stated where it is checked: the TPU kernel clamps a NaN's pattern (a
negative NaN to 0x7FFE, a positive one at 0x7FFE), which the port
reproduces, but on the CPU the JAX interpreter's ``maximum(x, 0)`` first
turns every NaN into the canonical 0x7FC0; for a NaN input of another
pattern the two outputs are both NaN and select the same columns, and
every other entry is bitwise equal. The scatter is
bitwise equal on integer-valued coeff/rows, whose f32 sums are exact in
any order, and within rtol 1e-6 on random values (the interpreter may
contract the multiply-add)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.ops import activations as jact
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch.ops import sparse_grad, topk_pallas


def _planted_rows(seed, B, width, dtype):
    """Integer-valued rows with exact ties, -0.0, rows with fewer than k
    positives and (bf16) NaN of both signs."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-6, 7, size=(B, width)).astype(np.float32)
    h[0, : width // 2] = 5.0                       # a tie far wider than k
    h[1] = -1.0
    h[1, 7] = 2.0                                  # one positive only
    h[2] = -0.0
    h[3, 100:110] = 3.0
    h[4] = 0.0
    if dtype == "bf16":
        h[5, 11] = np.nan
        h[6, :] = -np.nan                          # every slot a negative NaN
    return h


def _to_torch(h, dtype):
    t = torch.from_numpy(h)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


@pytest.mark.parametrize("width", [512, 1024, 1920])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_topk_plain_bitwise_equals_jax_composite_kernel(width, k):
    h = _planted_rows(width + k, 16, width, "bf16")
    hj = jnp.asarray(h, jnp.bfloat16)
    # the widest NaN payload 0x7FFF, then sign-set NaNs 0xFFC1 and 0xFFFF
    # (to its right, so that both NaN orders pick the same columns)
    bits = np.asarray(hj.view(jnp.uint16)).copy()
    bits[7, 2], bits[7, 5], bits[7, 6] = 0x7FFF, 0xFFC1, 0xFFFF
    hj = jnp.asarray(bits).view(jnp.bfloat16)
    want = np.asarray(jtp.topk(hj, k, interpret=True).view(jnp.uint16))
    ht = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
    got = topk_pallas.topk(ht, k).view(torch.int16).numpy().astype(np.uint16)
    other_nan = ((bits & 0x7FFF) > 0x7F80) & (bits != 0x7FC0)
    np.testing.assert_array_equal(got[~other_nan], want[~other_nan])
    assert (want[other_nan] != 0).sum() > 0
    np.testing.assert_array_equal(got[other_nan] != 0, want[other_nan] != 0)
    assert (got[other_nan & (got != 0)] == 0x7FFE).all()
    assert (want[other_nan & (want != 0)] == 0x7FC0).all()
    dense = jact._topk_dense(hj[8:], k)          # rows free of NaN: the dense oracle too
    np.testing.assert_array_equal(got[8:], np.asarray(dense.view(jnp.uint16)))


@pytest.mark.parametrize("width,k", [(512, 8), (1024, 32)])
def test_topk_plain_f32_bitwise_equals_jax_f32_kernel(width, k):
    h = _planted_rows(3, 12, width, "f32")
    want = jtp.topk(jnp.asarray(h), k, interpret=True)
    got = topk_pallas.topk(torch.from_numpy(h), k)
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.asarray(want).view(np.int32))
    np.testing.assert_array_equal(np.asarray(jact._topk_dense(jnp.asarray(h), k)),
                                  got.numpy())


def test_topk_backward_is_straight_through():
    h = torch.from_numpy(_planted_rows(4, 8, 512, "f32")).requires_grad_(True)
    out = topk_pallas.topk(h, 8)
    g = torch.randn_like(out)
    (out * g).sum().backward()
    torch.testing.assert_close(h.grad, torch.where(out > 0, g, 0.0), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("width,k", [(512, 8), (4096, 32), (1920, 4)])
def test_sparsify_plain_bitwise_equals_jax_kernel(dtype, width, k):
    rng = np.random.default_rng(width + k)
    f = np.zeros((40, width), np.float32)
    for r in range(40):
        n = int(rng.integers(0, k + 1))
        cols = rng.choice(width, size=n, replace=False)
        f[r, cols] = rng.integers(1, 9, size=n)
    f[0, ::3] = 2.0                                # a row far past k: slot k-1 overwritten
    f[1, -5:] = -1.0                               # negatives drain nothing
    f[2, 10] = np.nan                              # NaN drains nothing
    f[3, 20] = -0.0
    fj = jnp.asarray(f, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    vj, ij = jtp.sparsify(fj, k, interpret=True)
    vt, it = topk_pallas.sparsify(_to_torch(f, dtype), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if dtype == "bf16":
        np.testing.assert_array_equal(vt.view(torch.int16).numpy().astype(np.uint16),
                                      np.asarray(vj.view(jnp.uint16)))
    else:
        np.testing.assert_array_equal(vt.numpy().view(np.int32), np.asarray(vj).view(np.int32))


def test_sparsify_of_topk_mask_round_trips():
    h = torch.from_numpy(_planted_rows(5, 16, 2048, "f32")).to(torch.bfloat16)
    f = topk_pallas.topk(h, 32)
    vals, idx = topk_pallas.sparsify(f, 32)
    assert ((vals > 0).sum(dim=1) == (f > 0).sum(dim=1)).all()
    dense = torch.zeros(f.shape).index_put_((torch.arange(16)[:, None], idx.long()),
                                            vals.float(), accumulate=True)
    assert torch.equal(dense, f.float())


def _pairs(seed, B, k, n_out, integer):
    rng = np.random.default_rng(seed)
    if integer:
        coeff = rng.integers(-4, 5, size=(B, k)).astype(np.float32)
    else:
        coeff = rng.standard_normal((B, k)).astype(np.float32)
    idx = rng.integers(0, n_out, size=(B, k)).astype(np.int32)
    idx[:, 0] = 3                                  # every row hits latent 3
    idx[0, 1], idx[1, 1] = -1, n_out               # dropped
    idx[2, 2] = n_out + 7                          # dropped
    return coeff, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_out,m,B,k", [(512, 128, 16, 4), (256, 256, 32, 8), (1920, 128, 8, 4)])
def test_scatter_plain_bitwise_equals_jax_kernel_on_integers(n_out, m, B, k, dtype):
    coeff, idx = _pairs(n_out + m, B, k, n_out, integer=True)
    rows = np.random.default_rng(1).integers(-8, 9, size=(B, m)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jsg.scatter_add_rows(jnp.asarray(coeff), jnp.asarray(idx),
                                jnp.asarray(rows, jdt), n_out, use_pallas=True)
    got = sparse_grad.scatter_add_rows(torch.from_numpy(coeff), torch.from_numpy(idx),
                                       torch.from_numpy(rows).to(dtype), n_out)
    assert got.dtype == torch.float32 and got.shape == (n_out, m)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n_out,m,B,k", [(512, 128, 16, 4), (1920, 256, 32, 8)])
def test_scatter_plain_matches_jax_kernel_on_random(n_out, m, B, k):
    coeff, idx = _pairs(7, B, k, n_out, integer=False)
    rows = np.random.default_rng(2).standard_normal((B, m)).astype(np.float32)
    want = jsg.scatter_add_rows(jnp.asarray(coeff), jnp.asarray(idx), jnp.asarray(rows),
                                n_out, use_pallas=True)
    got = sparse_grad.scatter_add_rows(torch.from_numpy(coeff), torch.from_numpy(idx),
                                       torch.from_numpy(rows), n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gate_mirrors_equal_jax():
    for dict_size, k, n, d, B in [(512, 8, 2, 64, 32), (32768, 32, 2, 2304, 4096),
                                  (1920, 8, 2, 64, 32), (2 ** 17, 32, 2, 2304, 4096)]:
        assert (sparse_grad.decode_grad_supported(dict_size, k, n, d, B)
                == jsg.decode_grad_supported(dict_size, k, n, d, B))
        assert (sparse_grad.supported(dict_size, n * d, B, B * 64)
                == jsg.supported(dict_size, n * d, B, B * 64))
        assert topk_pallas.sparsify_supported(dict_size, k) == jtp.sparsify_supported(dict_size, k)
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            probe = jnp.zeros((1, dict_size), jdt)
            assert topk_pallas.supported(dict_size, k, tdt) == jtp.supported(probe, k)

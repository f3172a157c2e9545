"""The port's BatchTopK (crosscoder_tpu_torch/ops/topk_pallas.py batchtopk,
batchtopk_fixed; ops/activations.py) against the JAX package's dense
activations.batchtopk and its Pallas kernels in interpret mode, mirroring
tests/test_batchtopk_pallas.py.

Bar: bitwise on the output and on the straight-through gradient (the
threshold is an exact order statistic and the mask keeps every tie, so
there is nothing to round), for bf16 and f32, with ties at the threshold,
all-zero input, a budget above the count of positives, rows that are not a
multiple of the TPU's row block and widths that are not a multiple of its
chunk. NaN entries follow ROADMAP C1: a NaN ranks above +inf in both
packages, so it takes a slot and comes out NaN in the same place; the
bits of that NaN are not compared. The calibrated eval threshold has a
matmul inside, so it is held within rel 1e-6 in f32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import activations as jact
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import activations as act
from crosscoder_tpu_torch.ops import topk_pallas as tp


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


def _pair(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x, jnp.float32).astype(jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _assert_same(got, *wants):
    g = _tbits(got)
    nan = np.isnan(got.float().numpy())
    for w in wants:
        wn = np.isnan(np.asarray(w, np.float32))
        np.testing.assert_array_equal(nan, wn)
        np.testing.assert_array_equal(g[~nan], _bits(w)[~nan])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,width,k", [(16, 8192, 4), (5, 640, 3), (33, 256, 2),
                                       (7, 2304 + 128, 5)])
def test_batchtopk_bitwise_matches_dense_and_interpret(B, width, k, dtype):
    x = np.random.default_rng(B * width + k).normal(size=(B, width))
    hj, ht = _pair(x, dtype)
    want_dense = jact.batchtopk(hj, k, use_pallas=False)
    want = [want_dense]
    if jtp.batchtopk_supported(hj, k):
        want.append(jtp.batchtopk(hj, k, True))
    got = tp.batchtopk(ht, k)
    assert got.dtype == dtype and got.shape == ht.shape
    _assert_same(got, *want)
    _assert_same(act.batchtopk(ht, k), want_dense)
    assert int((got > 0).sum()) >= min(k * B, int((ht > 0).sum()))


def test_batchtopk_keeps_all_ties_at_threshold():
    h = np.full((4, 256), -1.0, np.float32)
    h[0, :7] = 2.0
    h[1, :6] = 1.0                  # 6 tied at the k*B = 8-th largest
    for dtype in (torch.float32, torch.bfloat16):
        hj, ht = _pair(h, dtype)
        out = tp.batchtopk(ht, 2)
        assert int((out > 0).sum()) == 13
        _assert_same(out, jact.batchtopk(hj, 2, use_pallas=False), jtp.batchtopk(hj, 2, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchtopk_all_zero_all_negative_and_full_budget(dtype):
    z = torch.zeros((4, 256), dtype=dtype)
    assert int((tp.batchtopk(z, 3) > 0).sum()) == 0
    neg = -torch.ones((3, 256), dtype=dtype)
    neg[1, 5] = -0.0
    assert _tbits(tp.batchtopk(neg, 3)).max() == 0            # +0.0 everywhere
    x = np.random.default_rng(0).normal(size=(4, 256))
    hj, ht = _pair(x, dtype)
    out = tp.batchtopk(ht, 256)                               # kk above the positives
    np.testing.assert_array_equal((out > 0).numpy(), (ht > 0).numpy())
    _assert_same(out, jact.batchtopk(hj, 256, use_pallas=False), jtp.batchtopk(hj, 256, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchtopk_nan_takes_a_slot_in_both(dtype):
    x = np.random.default_rng(4).normal(size=(6, 512))
    x[2, 17] = np.nan
    x[4, 300] = np.nan
    hj, ht = _pair(x, dtype)
    got = tp.batchtopk(ht, 4)
    assert torch.isnan(got[2, 17]) and torch.isnan(got[4, 300])
    _assert_same(got, jact.batchtopk(hj, 4, use_pallas=False), jtp.batchtopk(hj, 4, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchtopk_fixed_matches_dense_and_interpret(dtype):
    x = np.random.default_rng(7).normal(size=(6, 640))
    hj, ht = _pair(x, dtype)
    for threshold in (0.5, 1.25, 0.0, -0.5, -0.0, 0.3333):
        got = tp.batchtopk_fixed(ht, threshold)
        _assert_same(got, jact.batchtopk_fixed(hj, threshold, use_pallas=False),
                     jtp.batchtopk_fixed(hj, threshold, True))
        _assert_same(act.batchtopk_fixed(ht, threshold),
                     jact.batchtopk_fixed(hj, threshold, use_pallas=False))


def test_batchtopk_gradient_matches_jax():
    x = np.random.default_rng(3).normal(size=(8, 512)).astype(np.float32)
    g = np.random.default_rng(5).normal(size=(8, 512)).astype(np.float32)
    hj = jnp.asarray(x)
    gj_dense = jax.grad(lambda a: (jact.batchtopk(a, 4, use_pallas=False) * g).sum())(hj)
    gj_kernel = jax.grad(lambda a: (jtp.batchtopk(a, 4, True) * g).sum())(hj)
    ht = torch.from_numpy(x).requires_grad_(True)
    (tp.batchtopk(ht, 4) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(ht.grad.numpy(), np.asarray(gj_dense))
    np.testing.assert_array_equal(ht.grad.numpy(), np.asarray(gj_kernel))
    ht.grad = None
    (tp.batchtopk_fixed(ht, 0.5) * torch.from_numpy(g)).sum().backward()
    gf = jax.grad(lambda a: (jact.batchtopk_fixed(a, 0.5, use_pallas=False) * g).sum())(hj)
    np.testing.assert_array_equal(ht.grad.numpy(), np.asarray(gf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_of_equals_jax(dtype):
    x = np.random.default_rng(9).normal(size=(12, 1000))
    x[0, :50] = 1.5                                           # ties
    hj, ht = _pair(x, dtype)
    for k in (1, 4, 40, 2000):
        want = jact.batchtopk_threshold_of(jax.nn.relu(hj), k)
        got = act.batchtopk_threshold_of(torch.relu(ht), k)
        assert got.dtype == dtype
        np.testing.assert_array_equal(_tbits(got.reshape(1)), _bits(np.asarray(want)).reshape(1))
        # the value is the selected pattern of the kernel path
        if k * 12 <= int((ht > 0).sum()):
            kth = tp.batchtopk_select(ht, k * 12)
            np.testing.assert_array_equal(_tbits(tp.batchtopk_emit(got.reshape(1, 1),
                                                                   kth)), _tbits(got.reshape(1, 1)))


def test_select_plain_equals_sort_oracle():
    rng = np.random.default_rng(2)
    for dtype in (torch.float32, torch.bfloat16):
        h = torch.from_numpy(rng.normal(size=(9, 300)).astype(np.float32)).to(dtype)
        pats, _ = tp._bt_patterns(h)
        for kk in (1, 7, 100, 1000, 2700):
            s = torch.sort(pats, descending=True).values
            want = int(s[kk - 1]) if kk <= int((pats > 0).sum()) else 0
            assert int(tp.batchtopk_select(h, kk)) == want


def test_calibrated_threshold_matches_jax():
    kw = dict(d_in=32, n_models=2, dict_size=256, topk_k=8, activation="batchtopk",
              enc_dtype="fp32", seed=1)
    jcfg, cfg = JCfg(**kw), CrossCoderConfig(**kw)
    jparams = jcc.init_params(jax.random.key(0), jcfg)
    params = convert.crosscoder_params_from_numpy(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(16, 2, 32)).astype(np.float32) for _ in range(3)]
    want = jcc.calibrate_batchtopk_threshold(jparams, jcfg, batches)
    got = cc.calibrate_batchtopk_threshold(params, cfg, batches)
    assert got == pytest.approx(want, rel=1e-6)
    enc = cc.encode(params, torch.from_numpy(batches[0]), cfg.replace(batchtopk_threshold=got))
    jenc = jcc.encode(jparams, jnp.asarray(batches[0]), jcfg.replace(batchtopk_threshold=want))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-5, atol=1e-6)


def test_apply_dispatch_and_fused_gate(capsys):
    h = torch.randn(4, 256)
    cfg = CrossCoderConfig(activation="batchtopk", topk_k=3, dict_size=256)
    assert torch.equal(act.apply(h, cfg), tp.batchtopk(h, 3))
    assert torch.equal(act.apply(h, cfg.replace(batchtopk_threshold=0.5)),
                       tp.batchtopk_fixed(h, 0.5))
    assert not cc.use_fused_encoder(cfg)                       # auto: the dense encode
    assert cc.use_fused_encoder(cfg.replace(fused_encoder="on"))   # on: K4 in training mode
    assert not cc.use_fused_encoder(cfg.replace(fused_encoder="on", batchtopk_threshold=0.5))
    jcfg = CrossCoderConfig(activation="jumprelu", dict_size=256)
    with pytest.raises(ValueError, match="log_theta"):
        act.apply(h, jcfg)
    lt = torch.full((256,), -1.0)
    assert torch.equal(act.apply(h, jcfg, {"log_theta": lt}), h * (h > torch.exp(lt)))
    assert tp.batchtopk_select.launches == 0 and tp.batchtopk_emit.launches == 0

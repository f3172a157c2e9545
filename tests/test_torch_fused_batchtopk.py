"""The port's fused encoder→BatchTopK (K4: ops/fused_encoder_topk.py
fused_batchtopk_encode, models/crosscoder.py _FusedBatchTopKEncode) against
the JAX package's fused_batchtopk_encode_raw, its Pallas kernels run in
interpret mode, and against the JAX fused BatchTopK tier of training_loss.

Bars: the masked activations bitwise, bf16 and f32, on integer-valued
operands (the f32 sums are exact in any order), on JAX's own cases: an
exact tie at the global threshold with a width that is not a tile
multiple, and a positive bias with a row count that is not a row-block
multiple (padded rows must not enter the statistic). training_loss: the
loss bit-equal on integer-valued params and batch small enough that every
f32 sum of the loss is exact, gradients within ``2e-5·max|g|`` (JAX's bar
for its fused-vs-dense gradients, tests/test_fused_encoder_topk.py). The
Hopper kernels are held against the plain versions in
test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import topk_pallas as tp


@pytest.fixture(autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _tie_case():
    rng = np.random.default_rng(6)
    B, nd, H, k = 48, 128, 1000, 8
    W = rng.integers(-2, 3, size=(nd, H)).astype(np.float32)
    W[:, 500] = W[:, 9]                                  # exact global-threshold tie
    x = rng.integers(-3, 4, size=(B, nd)).astype(np.float32)
    b = rng.integers(-2, 3, size=(H,)).astype(np.float32)
    return x, W, b, k


def _padded_rows_case():
    rng = np.random.default_rng(7)
    B, nd, H, k = 33, 128, 512, 4
    x = rng.integers(-3, 4, size=(B, nd)).astype(np.float32)
    W = rng.integers(-2, 3, size=(nd, H)).astype(np.float32)
    b = np.full((H,), 3.0, np.float32)                   # every padded row would be positive
    return x, W, b, k


_DT = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("case", [_tie_case, _padded_rows_case], ids=["tie", "padded_rows"])
def test_plain_bitwise_matches_jax_kernel(case, dtype):
    x, W, b, k = case()
    tdt, jdt = _DT[dtype]
    got = fek.fused_batchtopk_encode(torch.from_numpy(x).to(tdt), torch.from_numpy(W).to(tdt),
                                     torch.from_numpy(b), k)
    want = jfek.fused_batchtopk_encode_raw(jnp.asarray(x, jdt), jnp.asarray(W, jdt),
                                           jnp.asarray(b), k, interpret=True)
    assert got.dtype == tdt and got.shape == (x.shape[0], W.shape[1])
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(_bits(got).dtype))
    # every tie at the threshold is kept: at least kk survivors
    assert int((got > 0).sum()) >= min(k * x.shape[0], int((got > 0).numel()))
    if case is _tie_case:
        assert torch.equal(got[:, 500] > 0, got[:, 9] > 0)


def test_select_and_emit_are_k9_over_the_pre_activations():
    """The plain select is K9's on the rounded pre-activations, and the
    emit at that threshold is K9's emit; a budget above the positives keeps
    every positive entry (threshold 0)."""
    x, W, b, k = _tie_case()
    x2, W2, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, W, b))
    h = (torch.matmul(x2.float(), W2.float()) + bt.float()).to(torch.bfloat16)
    for kk in (1, k * x.shape[0], h.numel()):
        kth = fek.fused_batchtopk_select(x2, W2, bt, kk)
        assert torch.equal(kth, tp.batchtopk_select_plain(h, kk))
        assert torch.equal(fek.fused_batchtopk_emit(x2, W2, bt, kth),
                           tp.batchtopk_emit_plain(h, kth))
    assert int(fek.fused_batchtopk_select(x2, W2, bt, h.numel())) == 0


def _int_params(cfg, seed):
    """Integer-valued params, sparse enough that every f32 sum of the loss
    stays exact (below 2^24)."""
    rng = np.random.default_rng(seed)
    n, d, H = cfg.n_sources, cfg.d_in, cfg.dict_size

    def sparse_ints(shape, p):
        return (rng.integers(-1, 2, size=shape) * (rng.random(shape) < p)).astype(np.float32)

    return {"W_enc": sparse_ints((n, d, H), 0.1), "W_dec": sparse_ints((H, n, d), 0.1),
            "b_enc": rng.integers(-1, 2, size=(H,)).astype(np.float32),
            "b_dec": np.zeros((n, d), np.float32)}


BT = dict(d_in=128, n_models=2, dict_size=1024, activation="batchtopk", topk_k=8,
          l1_coeff=0.0, batch_size=32, enc_dtype="fp32", master_dtype="fp32",
          fused_encoder="on")


def _loss_grads_both(kw, x, dead=None):
    jcfg, cfg = JCfg(**{**BT, **kw}), CrossCoderConfig(**{**BT, **kw})
    npp = _int_params(cfg, 1)
    jparams = {k: jnp.asarray(v) for k, v in npp.items()}
    extra_j, extra_p = {}, {}
    if dead is not None:
        extra_j = dict(dead_mask=jnp.asarray(dead), aux_coeff=0.5)
        extra_p = dict(dead_mask=torch.from_numpy(dead), aux_coeff=0.5)

    def jloss(p):
        return jcc.training_loss(p, jnp.asarray(x), 0.0, jcfg, with_metrics=False, **extra_j)[0]

    lj, gj = jax.value_and_grad(jloss)(jparams)
    params = {k: v.clone().requires_grad_(True)
              for k, v in convert.crosscoder_params_from_numpy(npp, device="cpu").items()}
    loss, _ = cc.training_loss(params, torch.from_numpy(x), 0.0, cfg, with_metrics=False,
                               **extra_p)
    names = sorted(params)
    gp = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    return (float(loss.detach()), {k: g.numpy() for k, g in gp.items()},
            float(lj), {k: np.asarray(v) for k, v in gj.items()})


def _assert_grads(gp, gj):
    for name in gj:
        scale = max(float(np.abs(gj[name]).max()), 1e-6)
        np.testing.assert_allclose(gp[name], gj[name], atol=2e-5 * scale, rtol=0,
                                   err_msg=f"gradient of {name}")


def test_training_loss_and_grads_match_jax_fused_tier():
    x = np.random.default_rng(8).integers(-1, 2, size=(32, 2, 128)).astype(np.float32)
    assert cc.use_fused_encoder(CrossCoderConfig(**BT), 32)
    assert jcc.use_fused_encoder(JCfg(**BT), 32)
    calls = fek.fused_batchtopk_encode
    seen = []
    fek.fused_batchtopk_encode = lambda *a: seen.append(1) or calls(*a)
    try:
        lp, gp, lj, gj = _loss_grads_both({}, x)
    finally:
        fek.fused_batchtopk_encode = calls
    assert seen == [1]
    assert lp == lj and np.isfinite(lp) and lp > 0
    _assert_grads(gp, gj)
    # the dense tier gives the same loss (the fused forward changes no value)
    lpd, gpd, _, _ = _loss_grads_both(dict(fused_encoder="off"), x)
    assert lpd == lp
    _assert_grads(gpd, gp)


def test_dispatch_auto_threshold_and_aux_steps(capsys, monkeypatch):
    cfg = CrossCoderConfig(**BT)
    assert cc.use_fused_encoder(cfg, 32)
    assert not cc.use_fused_encoder(cfg.replace(fused_encoder="auto"), 32)
    assert not cc.use_fused_encoder(cfg.replace(fused_encoder="off"), 32)
    cc._FUSED_DEMOTION_WARNED.clear()
    assert not cc.use_fused_encoder(cfg.replace(batchtopk_threshold=0.5), 32)
    assert "demoted to the dense encode" in capsys.readouterr().err
    # AuxK steps keep the dense encode (the aux ranking needs the pre-acts)
    seen = []
    real = fek.fused_batchtopk_encode
    monkeypatch.setattr(fek, "fused_batchtopk_encode", lambda *a: seen.append(1) or real(*a))
    x = np.random.default_rng(9).integers(-1, 2, size=(32, 2, 128)).astype(np.float32)
    dead = np.random.default_rng(10).random(1024) < 0.5
    lp, gp, lj, gj = _loss_grads_both(dict(aux_k=16), x, dead)
    assert seen == []
    lpd, gpd, _, _ = _loss_grads_both(dict(aux_k=16, fused_encoder="off"), x, dead)
    assert lp == lpd
    for name in gp:
        np.testing.assert_array_equal(gp[name], gpd[name], err_msg=name)
    assert lp == pytest.approx(lj, rel=1e-6)
    _assert_grads(gp, gj)

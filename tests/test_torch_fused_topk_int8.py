"""The port's int8 block-scaled fused encoder→TopK (K3:
ops/fused_encoder_topk.py fused_topk_encode(..., quant_block),
ops/quant.py quantize_contraction; the quant_encoder tier of
models/crosscoder.py) against the JAX package's fused_topk_encode with
quant_block, its Pallas kernel run in interpret mode under ``jax.jit`` (the
compiled form of the int8 scale, ROADMAP C3), and against JAX's
quant_encoder tier of training_loss.

Bars: the operands' quantization bitwise; the selected indices equal and
the values within 2 f32 ulps (f32) or equal (bf16): XLA-CPU contracts one
multiply and add of the jitted block fold into an FMA, so its f32
pre-activations can differ from the port's step-by-step rounding in the
last bits (ROADMAP C7). The quality bounds are JAX's own
(tests/test_fused_encoder_topk.py): selection overlap >= 0.9 and mean
value error < 5e-3 against the exact fused encoder; the quant tier's loss
within 5% of the exact fused tier's. The Hopper kernel is held bitwise
against the plain version in test_torch_kernels_cuda.py."""

import json

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
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.train import main as tmain


@pytest.fixture(autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


_DT = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _gaussian(seed, B, nd, H):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nd)).astype(np.float32),
            (rng.standard_normal((nd, H)) * 0.05).astype(np.float32),
            (rng.standard_normal(H) * 0.01).astype(np.float32))


@pytest.mark.parametrize("dtype", sorted(_DT))
def test_quantize_contraction_equals_jitted_jax(dtype):
    x, W, _ = _gaussian(0, 24, 256, 1000)
    tdt, jdt = _DT[dtype]
    got = quant.quantize_contraction(torch.from_numpy(x).to(tdt), torch.from_numpy(W).to(tdt), 128)
    want = jax.jit(lambda a, w: jfek._quantize_contraction(a, w, 128))(
        jnp.asarray(x, jdt), jnp.asarray(W, jdt))
    assert [tuple(t.shape) for t in got] == [(24, 256), (24, 2), (256, 1000), (2, 1000)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("dtype", sorted(_DT))
def test_plain_matches_jitted_jax_kernel(dtype, k):
    x, W, b = _gaussian(1, 24, 256, 1000)              # a width that is not a tile multiple
    tdt, jdt = _DT[dtype]
    vals, idx = fek.fused_topk_encode(torch.from_numpy(x).to(tdt), torch.from_numpy(W).to(tdt),
                                      torch.from_numpy(b), k, quant_block=128)
    jv, ji = jax.jit(lambda a, w, c: jfek.fused_topk_encode(a, w, c, k, quant_block=128,
                                                           interpret=True))(
        jnp.asarray(x, jdt), jnp.asarray(W, jdt), jnp.asarray(b))
    assert vals.dtype == tdt and idx.dtype == torch.int32 and vals.shape == (24, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    got, want = vals.float().numpy(), np.asarray(jv, np.float32)
    if tdt == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        ulps = np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))
        assert float(ulps.max()) <= 2, float(ulps.max())
    assert fek.fused_topk_encode_q.launches == 0


def test_quant_dispatch_and_plain_versions():
    x, W, b = _gaussian(2, 8, 256, 512)
    args = (torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b), 8)
    q = fek.fused_topk_encode(*args, quant_block=128)
    for other in (fek.fused_topk_encode_q(*args, 128), fek.fused_topk_encode_plain(*args, quant_block=128),
                  fek.fused_topk_encode_q_plain(*args, 128)):
        assert torch.equal(q[0], other[0]) and torch.equal(q[1], other[1])
    with pytest.raises(ValueError, match="quant block"):
        fek.check_supported_q(*args, 96)
    fek.check_supported_q(*args, 128)


@pytest.mark.parametrize("B,qb", [(1, 32), (3, 96), (130, 128), (8, 256)])
def test_q_operands_layout_matches_the_plain_scales(B, qb):
    """K3's operand layouts (q_operands): xq and the W scales as the plain
    quantization has them, wqT its wq transposed (K-major), xsT
    its xs transposed with the rows padded to a multiple of 4 with zeros."""
    x, W, _ = _gaussian(B + qb, B, 768, 520)
    x2, W2 = torch.from_numpy(x), torch.from_numpy(W)
    xq, xsT, wqT, ws = fek.q_operands(x2, W2, qb)
    pxq, pxs, pwq, pws = quant.quantize_contraction(x2, W2, qb)
    nb, Bp = 768 // qb, -(-B // 4) * 4
    assert xsT.shape == (nb, Bp) and xsT.dtype == torch.float32
    assert torch.equal(xsT[:, :B].view(torch.int32), pxs.t().contiguous().view(torch.int32))
    assert not bool(xsT[:, B:].any())
    assert torch.equal(xq, pxq) and torch.equal(wqT, pwq.t()) and wqT.shape == (520, 768)
    assert torch.equal(ws.view(torch.int32), pws.contiguous().view(torch.int32))
    assert all(t.is_contiguous() for t in (xq, xsT, wqT, ws))


def test_quality_bounds_against_the_exact_fused_encoder():
    """JAX's quality-bound case: B 64, nd 512, H 2048, k 16, block 128."""
    x, W, b = _gaussian(5, 64, 512, 2048)
    x2, W2, bt = torch.from_numpy(x).bfloat16(), torch.from_numpy(W).bfloat16(), torch.from_numpy(b)
    ev, ei = fek.fused_topk_encode(x2, W2, bt, 16)
    qv, qi = fek.fused_topk_encode(x2, W2, bt, 16, quant_block=128)
    ev, qv, ei, qi = ev.float().numpy(), qv.float().numpy(), ei.numpy(), qi.numpy()
    overlap = np.mean([len(set(qi[r][qv[r] > 0]) & set(ei[r][ev[r] > 0]))
                       / max((ev[r] > 0).sum(), 1) for r in range(64)])
    assert overlap >= 0.9, overlap
    rel = np.abs(qv.sum(1) - ev.sum(1)) / np.maximum(ev.sum(1), 1e-6)
    assert float(rel.mean()) < 5e-3, float(rel.mean())


TOPK = dict(d_in=128, n_models=2, dict_size=1024, activation="topk", topk_k=8, l1_coeff=0.0,
            batch_size=32, enc_dtype="fp32", master_dtype="fp32", factored_decode="on",
            sparse_bwd="on", fused_encoder="on")


def _port_loss_grads(cfg, params, x):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = cc.training_loss(p, torch.from_numpy(x), 0.0, cfg, with_metrics=False)
    names = sorted(p)
    return float(loss.detach()), dict(zip(names, (g.numpy() for g in torch.autograd.grad(
        loss, [p[n] for n in names]))))


def test_training_loss_quant_tier_tracks_exact_and_matches_jax():
    jcfg = JCfg(**TOPK, quant_encoder=True, quant_block=128)
    cfg = CrossCoderConfig(**TOPK, quant_encoder=True, quant_block=128)
    jparams = jcc.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    params = convert.crosscoder_params_from_numpy(jax.device_get(jparams), device="cpu")
    x = np.random.default_rng(10).standard_normal((32, 2, 128)).astype(np.float32)
    seen = []
    real = fek.fused_topk_encode_q
    fek.fused_topk_encode_q = lambda *a: seen.append(a[-1]) or real(*a)
    try:
        lq, gq = _port_loss_grads(cfg, params, x)
    finally:
        fek.fused_topk_encode_q = real
    assert seen == [128]
    le, _ = _port_loss_grads(cfg.replace(quant_encoder=False), params, x)
    assert np.isfinite(lq) and abs(lq - le) / max(abs(le), 1e-6) < 0.05
    assert all(np.all(np.isfinite(g)) for g in gq.values())

    def jloss(p):
        return jcc.training_loss(p, jnp.asarray(x), 0.0, jcfg, with_metrics=False)[0]

    lj, gj = jax.jit(jax.value_and_grad(jloss))(jparams)
    assert lq == pytest.approx(float(lj), rel=1e-5)
    for name, g in gj.items():
        g = np.asarray(g)
        np.testing.assert_allclose(gq[name], g, atol=2e-5 * max(float(np.abs(g).max()), 1e-6),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("flags,wrapper", [
    (["--activation", "topk", "--topk-k", "8", "--sparse-bwd", "on", "--fused-encoder", "on",
      "--quant-encoder", "true", "--quant-block", "128"], "fused_topk_encode_q"),
    (["--activation", "batchtopk", "--topk-k", "4", "--fused-encoder", "on"],
     "fused_batchtopk_encode"),
], ids=["quant_encoder", "fused_batchtopk"])
def test_train_main_runs_the_fused_tiers(tmp_path, monkeypatch, flags, wrapper):
    calls = []
    real = getattr(fek, wrapper)
    monkeypatch.setattr(fek, wrapper, lambda *a: calls.append(1) or real(*a))
    tr = tmain.main(["--data-source", "synthetic", "--d-in", "64", "--dict-size", "256",
                     "--batch-size", "16", "--num-tokens", "64", "--l1-coeff", "0",
                     "--log-every", "1", "--log-backend", "jsonl", "--log-print-every", "0",
                     "--checkpoint-dir", str(tmp_path), *flags], device="cpu")
    assert tr.state.step == 4 and len(calls) == 4
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["l0_loss"] > 0 for r in rows)

"""The port's serve path (crosscoder_tpu_torch/serve/) on the CPU.

Against the JAX package: the port's ``InferenceEngine(device="cpu")``,
built through crosscoder_tpu_torch/convert.py from the weights of the JAX
``serve.smoke.build_engine`` stack, serves what a JAX oracle computes (the
padded ``run_with_cache_multi``, then the Pallas fused encoder→TopK in
interpret mode on the same last-token rows, then ``relative_norms``):
equal index sets, vals within rtol 1e-4, diff within 1e-6.

Within the port: bucket padding and the extend path against solo /
re-prefill runs (allclose: CPU matmul rounding may depend on the batch),
the deadline and shed admission semantics, and warmup."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.analysis import decoder as jdecoder
from crosscoder_tpu.models import crosscoder as jcrosscoder
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu.serve import smoke as jsmoke
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.analysis import decoder
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.paging import ContinuousBatcher
from crosscoder_tpu_torch.models import crosscoder, lm
from crosscoder_tpu_torch.obs import trace
from crosscoder_tpu_torch.serve import InferenceEngine, Shed, batch_buckets, bucket_of
from crosscoder_tpu_torch.serve.smoke import build_engine, oracle, serve_batch, serve_plain

SEQ = 16


class Clock:
    """Injected engine clock: tests advance time, nothing sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _jax_kernels_plain():
    jfek.set_interpret(False)
    jpa.set_interpret(False)
    yield
    jfek.set_interpret(False)
    jpa.set_interpret(False)


@pytest.fixture(scope="module")
def jax_stack():
    _, jcfg, jlm_cfg, jparams, jcc = jsmoke.build_engine(serve_max_batch=8)
    return jcfg, jlm_cfg, jparams, jcc


def _port_engine(jax_stack, clock=None):
    jcfg, jlm_cfg, jparams, jcc = jax_stack
    cfg = CrossCoderConfig.from_dict(jcfg.to_dict())
    lm_cfg = lm.LMConfig(**dataclasses.asdict(jlm_cfg))
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    cc = convert.crosscoder_params_from_numpy(jax.device_get(jcc), device="cpu")
    kw = {} if clock is None else {"clock": clock}
    return InferenceEngine(cfg, lm_cfg, params, cc, device="cpu", **kw)


def _docs(rng, vocab, lengths):
    return [rng.integers(1, vocab, size=int(n), dtype=np.int32) for n in lengths]


def _padded(docs):
    tokens = np.zeros((len(docs), SEQ), np.int32)
    for d, doc in enumerate(docs):
        tokens[d, : len(doc)] = doc
    return tokens, np.asarray([len(d) for d in docs], np.int32)


def _jax_oracle(jax_stack, tokens, lengths, pair):
    jcfg, jlm_cfg, jparams, jcc = jax_stack
    hooks = jcfg.resolved_hook_points()
    caps = jlm.run_with_cache_multi(jparams, jnp.asarray(tokens), jlm_cfg, hooks)
    B = tokens.shape[0]
    x = caps[jnp.arange(B), jnp.asarray(lengths) - 1].astype(jnp.float32)   # [B, n, d]
    x = x.reshape(B, -1)
    W = jcc["W_enc"].reshape(-1, jcc["W_enc"].shape[-1])
    vals, idx = jfek.fused_topk_encode(x, W, jcc["b_enc"], jcfg.topk_k, interpret=True)
    diff = jdecoder.relative_norms(jcc, pair)[idx]
    return np.asarray(vals), np.asarray(idx), np.asarray(diff)


@pytest.mark.parametrize("lengths", [[1, SEQ, 7, 3, 9, 5, SEQ, 2], [5, SEQ, 2]])
def test_served_matches_jax_oracle(jax_stack, lengths):
    eng = _port_engine(jax_stack)
    docs = _docs(np.random.default_rng(0), 257, lengths)
    res = serve_batch(eng, docs)
    assert [r.bucket for r in res] == [bucket_of(len(lengths), 8)] * len(lengths)
    tokens, lens = _padded(docs)
    vals, idx, diff = _jax_oracle(jax_stack, tokens, lens, eng._pair)
    for i, r in enumerate(res):
        assert r.idx.dtype == np.int32 and r.vals.shape == (eng.cfg.topk_k,)
        np.testing.assert_array_equal(r.idx, idx[i], err_msg=f"doc {i}")
        np.testing.assert_allclose(r.vals, vals[i], rtol=1e-4, atol=1e-6, err_msg=f"doc {i}")
        np.testing.assert_allclose(r.diff, diff[i], rtol=0, atol=1e-6, err_msg=f"doc {i}")


def test_paged_serve_matches_padded_oracle_and_plain_rerun():
    eng, _, lm_cfg, _, _ = build_engine(device="cpu")
    docs = _docs(np.random.default_rng(1), lm_cfg.vocab_size, [4, SEQ, 1, 11, 6])
    res = serve_batch(eng, docs)
    tokens, lens = _padded(docs)
    want = oracle(eng, tokens, lens)
    plain = serve_plain(eng, docs)
    for i, r in enumerate(res):
        for got, a, b in ((r.vals, want[0][i], plain[0][i]), (r.idx, want[1][i], plain[1][i]),
                          (r.diff, want[2][i], plain[2][i])):
            np.testing.assert_allclose(got, a, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(got, b)      # same path, same kernels on the CPU
    assert plain[3].shape == (5, 4, lm_cfg.d_model)


def test_bucket_padding_invisible():
    eng, _, lm_cfg, _, _ = build_engine(device="cpu")
    docs = _docs(np.random.default_rng(2), lm_cfg.vocab_size, [5, SEQ, 2])
    together = serve_batch(eng, docs)
    assert [r.bucket for r in together] == [4, 4, 4]
    for doc, r in zip(docs, together):
        solo = serve_batch(eng, [doc])[0]
        assert solo.bucket == 1
        np.testing.assert_array_equal(r.idx, solo.idx)
        np.testing.assert_allclose(r.vals, solo.vals, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r.diff, solo.diff, rtol=0, atol=1e-7)


def test_extend_matches_reprefill_and_keeps_prefix_pages():
    eng, _, lm_cfg, _, _ = build_engine(device="cpu")
    full = np.random.default_rng(3).integers(1, lm_cfg.vocab_size, size=SEQ, dtype=np.int32)
    rid = eng.submit(full[: SEQ // 2], keep=True)
    before = eng.pages_of(rid)
    eng.step(force=True)
    eng.extend(rid, full[SEQ // 2:])
    after = eng.pages_of(rid)
    assert after[: len(before)] == before and len(after) > len(before)
    ext = eng.step(force=True)[0]
    assert ext.extended and ext.request_id == rid
    eng.release(rid)
    fresh = serve_batch(eng, [full])[0]
    np.testing.assert_array_equal(ext.idx, fresh.idx)
    np.testing.assert_allclose(ext.vals, fresh.vals, rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError, match="not live"):
        eng.extend(rid, np.ones(2, np.int32))


def test_bucket_helpers_and_deadline():
    assert batch_buckets(8) == (1, 2, 4, 8)
    assert bucket_of(3, 8) == 4 and bucket_of(9, 8) == 8
    cb = ContinuousBatcher(seq_len=8, n_rows=2, max_wait_s=0.05)
    assert cb.admit(np.ones(3, np.int32), now=1.0)
    assert not cb.due(1.03) and cb.due(1.06)
    clk = Clock()
    eng, _, lm_cfg, _, _ = build_engine(device="cpu", clock=clk)
    eng.submit(_docs(np.random.default_rng(4), lm_cfg.vocab_size, [4])[0])
    clk.t = 0.001
    assert eng.step() == []
    clk.t = 0.0021
    res = eng.step()
    assert len(res) == 1 and res[0].bucket == 1 and res[0].queue_wait_ms >= 2.0


def test_queue_full_and_stale_requests_shed():
    eng, _, lm_cfg, _, _ = build_engine(device="cpu", serve_max_batch=1, serve_queue=2,
                                        batch_size=32)
    a, b, c = _docs(np.random.default_rng(5), lm_cfg.vocab_size, [3, 4, 5])
    eng.submit(a)
    eng.submit(b)
    with pytest.raises(Shed, match="queue full"):
        eng.submit(c)
    assert eng.stats()["serve/shed_total"] == 1 and eng.n_queued == 2
    assert len(eng.drain_queue()) == 2 and eng.n_queued == 0

    clk = Clock()
    eng, _, lm_cfg, _, _ = build_engine(device="cpu", serve_shed_ms=50.0, clock=clk)
    rng = np.random.default_rng(6)
    stale = eng.submit(_docs(rng, lm_cfg.vocab_size, [4])[0])
    clk.t = 0.2
    fresh = eng.submit(_docs(rng, lm_cfg.vocab_size, [4])[0])
    assert [r.request_id for r in eng.step(force=True)] == [fresh]
    assert eng.was_shed(stale) and not eng.was_shed(fresh)


def test_page_pool_exhaustion_sheds():
    eng, cfg, lm_cfg, _, _ = build_engine(device="cpu", serve_max_batch=1, serve_queue=1)
    rng = np.random.default_rng(7)
    held = []
    with pytest.raises(Shed, match="page pool"):
        for _ in range(cfg.serve_queue + cfg.serve_max_batch + 1):
            held.append(eng.submit(_docs(rng, lm_cfg.vocab_size, [SEQ])[0], keep=True))
            eng.step(force=True)
    assert eng.stats()["serve/shed_total"] == 1
    eng.release(held[0])
    eng.submit(_docs(rng, lm_cfg.vocab_size, [SEQ])[0])


def test_engine_requires_serve_on_and_matching_device():
    cfg = CrossCoderConfig(d_in=32, dict_size=64, enc_dtype="fp32")
    with pytest.raises(ValueError, match="serve"):
        InferenceEngine(cfg, None, [], {}, device="cpu")
    eng, cfg, lm_cfg, params, cc = build_engine(device="cpu")
    with pytest.raises(ValueError, match="live on"):
        InferenceEngine(cfg, lm_cfg, params, cc, device="meta")


def test_warmup_runs_every_bucket():
    eng, _, _, _, _ = build_engine(device="cpu", serve_max_batch=4)
    assert eng.warmup() == 3
    assert eng.stats()["serve/prefill_ms_n"] == 3


def test_crosscoder_and_decoder_match_jax(jax_stack):
    """pre_acts (function and module), decoder norms and relative norms on
    the converted JAX crosscoder params."""
    jcfg, _, _, jcc = jax_stack
    cc = convert.crosscoder_params_from_numpy(jax.device_get(jcc), device="cpu")
    x = np.random.default_rng(8).normal(size=(5, jcfg.n_sources, jcfg.d_in)).astype(np.float32)
    want = np.asarray(jcrosscoder.pre_acts(jcc, jnp.asarray(x)))
    got = crosscoder.pre_acts(cc, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    module = crosscoder.CrossCoder(cc)
    assert torch.equal(module(torch.from_numpy(x)), got)
    assert sorted(module.params()) == ["W_dec", "W_enc", "b_dec", "b_enc"]
    np.testing.assert_allclose(decoder.decoder_norms(cc).numpy(),
                               np.asarray(jdecoder.decoder_norms(jcc)), rtol=1e-6)
    np.testing.assert_allclose(decoder.relative_norms(cc, (0, 2)).numpy(),
                               np.asarray(jdecoder.relative_norms(jcc, (0, 2))), atol=1e-7)
    mine = crosscoder.init_params(CrossCoderConfig.from_dict(jcfg.to_dict()), seed=3,
                                  device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in cc.items()}
    np.testing.assert_allclose(torch.linalg.norm(mine["W_dec"], dim=-1).numpy(),
                               jcfg.dec_init_norm, rtol=1e-5)


class _Recorder:
    def __init__(self):
        self.events = []

    def span(self, name, **args):
        self.events.append(("span", name, args))
        return trace.NullTracer().span(name)

    def instant(self, name, **args):
        self.events.append(("instant", name, args))


def test_engine_spans_reach_an_installed_tracer():
    rec = _Recorder()
    prev = trace.set_tracer(rec)
    try:
        eng, _, lm_cfg, _, _ = build_engine(device="cpu")
        serve_batch(eng, _docs(np.random.default_rng(9), lm_cfg.vocab_size, [3, 5]))
    finally:
        trace.set_tracer(prev)
    assert [(k, n) for k, n, _ in rec.events] == [
        ("span", "prefill"), ("span", "encode"), ("instant", "queue_wait")]
    assert rec.events[0][2] == {"bucket": 2}

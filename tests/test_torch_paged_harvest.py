"""The port's paged harvest (crosscoder_tpu_torch/models/lm.py
``run_with_cache_multi_paged``; crosscoder_tpu_torch/data/buffer.py under
``harvest_runtime="paged"``) against the JAX package's.

Tiny Gemma-2 pair (4 layers, d_model 32), weights carried across by
crosscoder_tpu_torch/convert.py, numpy-seeded tokens with ragged lengths
(trailing PAD ids). Bars: the paged capture and the paged buffer's norm
factors, store and served batches at 1e-5 against JAX in f32 (two
frameworks' forwards round apart; the port's paged capture is held to the
same bar in tests/test_torch_lm.py); on an all-full-length chunk the
packing is the identity and the port's paged capture is bitwise its own
padded one (JAX's gate); the wrap gather's source rows exactly as JAX's
``tests/test_paging.py::test_paged_wrap_mode_recycles_real_rows``;
``padding_efficiency`` equal to JAX's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import paged_attention as pa

S = 16
HOOKS = ("blocks.1.hook_resid_pre", "blocks.3.hook_resid_pre")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_xla_attention():
    """The JAX paged path takes its XLA attention with interpret off."""
    jpa.set_interpret(False)
    yield
    jpa.set_interpret(False)


@pytest.fixture(scope="module")
def models():
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(s), jcfg) for s in (1, 2)]
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    return jcfg, jparams, lm.LMConfig.tiny(), params


def _ragged(seed, lengths, seq=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 257, size=(len(lengths), seq), dtype=np.int64)
    for d, ln in enumerate(lengths):
        tokens[d, ln:] = 0
    return tokens, np.asarray(lengths)


@pytest.mark.parametrize("pad_mode", ["zero", "wrap"])
@pytest.mark.parametrize("page", [4, 8])
def test_paged_multi_matches_jax(models, pad_mode, page):
    jcfg, jparams, cfg, params = models
    tokens, lengths = _ragged(4, [1, S, 7, 3, 9, 5])
    want = np.asarray(jlm.run_with_cache_multi_paged(
        jparams, tokens, lengths, jcfg, HOOKS, page_size=page, pad_mode=pad_mode), np.float32)
    got = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=page,
                                        pad_mode=pad_mode)
    assert tuple(got.shape) == want.shape == (6, S, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_paged_multi_row_multiple_and_out_dtype_match_jax(models):
    jcfg, jparams, cfg, params = models
    tokens, lengths = _ragged(5, [2, 3, 4, 5, 6, 2, 3, 16])
    want = np.asarray(jlm.run_with_cache_multi_paged(
        jparams, tokens, lengths, jcfg, HOOKS, page_size=8, row_multiple=4, pad_mode="wrap",
        out_dtype=jnp.bfloat16), np.float32)
    got = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8,
                                        row_multiple=4, pad_mode="wrap",
                                        out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of values that agree to 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7, atol=TOL)


def test_paged_full_length_bitwise_equals_padded(models):
    """All-full-length chunk: identity packing, the padded forward's ops in
    its order, so the plain-attention paged capture is bitwise the padded
    one (zero and wrap alike)."""
    _, _, cfg, params = models
    tokens, lengths = _ragged(3, [S] * 6)
    want = lm.run_with_cache_multi(params, torch.as_tensor(tokens), cfg, HOOKS)
    for mode in ("zero", "wrap"):
        got = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8,
                                            pad_mode=mode)
        assert torch.equal(got, want), mode


def test_paged_wrap_mode_recycles_real_rows(models):
    """Positions past a length repeat the document's own post-BOS rows in
    cycle order; a single-token document repeats its BOS row; a full
    document is untouched; another pad_mode raises."""
    _, _, cfg, params = models
    tokens, lengths = _ragged(9, [1, 4, S])
    got = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8,
                                        pad_mode="wrap").numpy()
    for t, src in [(4, 1), (5, 2), (6, 3), (7, 1)]:
        np.testing.assert_array_equal(got[1, t], got[1, src])
    for t in range(1, S):
        np.testing.assert_array_equal(got[0, t], got[0, 0])
    zero = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8)
    np.testing.assert_array_equal(got[2], zero[2].numpy())
    assert np.abs(got[2]).sum() > 0
    with pytest.raises(ValueError, match="pad_mode"):
        lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8,
                                      pad_mode="mask")


def test_paged_multi_takes_the_attention_it_is_given(models):
    """The attention argument is the one every layer calls (the card's
    plain re-run passes the plain version)."""
    _, _, cfg, params = models
    tokens, lengths = _ragged(6, [3, S, 9])
    calls = []

    def attention(*a, **kw):
        calls.append(kw["window"])
        return pa.paged_attention_plain(*a, **kw)

    got = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8,
                                        attention=attention)
    want = lm.run_with_cache_multi_paged(params, tokens, lengths, cfg, HOOKS, page_size=8)
    assert torch.equal(got, want)
    # 3 blocks below the highest hook, 2 models; even layers windowed
    assert calls == [cfg.sliding_window, 0, cfg.sliding_window] * 2


# ---------------------------------------------------------------------------
# the paged replay buffer


def _kw(**kw):
    base = dict(batch_size=32, buffer_mult=16, seq_len=17, d_in=32, n_models=2,
                model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
                seed=3, page_size=1, harvest_runtime="paged")
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(8)
    tokens = rng.integers(1, 257, size=(128, 17), dtype=np.int64)
    for d, ln in enumerate(rng.integers(2, 18, size=128)):
        tokens[d, ln:] = 0
    return tokens


@pytest.mark.parametrize("store", ["host", "hbm"])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_buffer_matches_jax_paged_buffer(models, corpus, store, quant):
    """Norm factors, the store and 12 served batches (across two refill
    cycles) against the JAX paged buffer, and the same padding
    efficiency; int8 stores within one quantization step."""
    jcfg, jparams, cfg, params = models
    kw = _kw(buffer_device=store, quant_buffer=quant, quant_block=16)
    jb = jbuf.make_buffer(JCfg(**kw), jcfg, jparams, corpus)
    pb = buf.make_buffer(CrossCoderConfig(**kw), cfg, params, corpus, device="cpu")
    np.testing.assert_allclose(pb.normalisation_factor, jb.normalisation_factor, rtol=TOL)
    assert pb.padding_efficiency() == jb.padding_efficiency() < 1.0

    def close(a, b):
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        step = np.abs(b).max() / 127 if quant else 0.0
        # bf16 rows: one bf16 rounding of values that agree to 1e-5
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=TOL + step)

    close(pb._store, jb._store)
    for _ in range(12):
        close(pb.next_raw(), jb.next_raw())
        assert pb.token_pointer == jb.token_pointer
    assert pb.padding_efficiency() == jb.padding_efficiency()
    assert pb.state_dict()["token_pointer"] == jb.state_dict()["token_pointer"]


def test_paged_buffer_on_full_length_corpus_equals_padded_buffer(models):
    """On an all-full-length corpus the paged buffer stores and serves the
    padded buffer's stream byte for byte, at an efficiency of 1."""
    _, _, cfg, params = models
    tokens = np.random.default_rng(7).integers(1, 257, size=(64, 17), dtype=np.int64)
    pad = buf.make_buffer(CrossCoderConfig(**_kw(harvest_runtime="padded")), cfg, params,
                          tokens, device="cpu")
    pag = buf.make_buffer(CrossCoderConfig(**_kw()), cfg, params, tokens, device="cpu")
    assert torch.equal(pad._store, pag._store)
    np.testing.assert_array_equal(pad.normalisation_factor, pag.normalisation_factor)
    for _ in range(10):
        assert torch.equal(pad.next_raw(), pag.next_raw())
    assert pag.padding_efficiency() == 1.0 and pad.padding_efficiency() is None


def test_ragged_corpus_never_stores_a_zero_row(models, corpus):
    """Pad positions wrap the document's real rows: no all-zero row enters
    the store, through the fill and two refill cycles."""
    _, _, cfg, params = models
    b = buf.make_buffer(CrossCoderConfig(**_kw()), cfg, params, corpus, device="cpu")
    for i in range(16):
        if i % 8 == 0:
            assert (b._store.float().abs().sum(dim=(1, 2)) > 0).all()
        x = b.next_raw().float()
        assert torch.isfinite(x).all() and (x.abs().sum(dim=(1, 2)) > 0).all()
    assert (b._store.float().abs().sum(dim=(1, 2)) > 0).all()
    assert 0.1 < b.padding_efficiency() < 1.0


def test_paged_buffer_paces_one_quantum_a_chunk(models, corpus):
    """The paged harvest is one dispatch a chunk (a single-dispatch job);
    the padded one is SegmentedHarvest's count of quanta."""
    _, _, cfg, params = models
    pag = buf.make_buffer(CrossCoderConfig(**_kw()), cfg, params, corpus, device="cpu",
                          lazy=True)
    pad = buf.make_buffer(CrossCoderConfig(**_kw(harvest_runtime="padded")), cfg, params,
                          corpus, device="cpu", lazy=True)
    assert pag._segs_per_chunk() == 1
    assert pad._segs_per_chunk() == lm.SegmentedHarvest.count(cfg, pad.hook_points, 2) == 2
    assert isinstance(pag._harvest_job(corpus[:4]), buf._SingleDispatchJob)
    assert isinstance(pad._harvest_job(corpus[:4]), lm.SegmentedHarvest)


def test_trainer_logs_padding_efficiency(models, corpus, tmp_path):
    """The trainer logs ``harvest/padding_efficiency`` over a paged buffer,
    as the JAX trainer does; a padded run logs no such key."""
    import json

    from crosscoder_tpu_torch.train.trainer import Trainer
    from crosscoder_tpu_torch.utils.logging import MetricsLogger

    _, _, cfg, params = models
    for runtime in ("paged", "padded"):
        ccfg = CrossCoderConfig(**_kw(harvest_runtime=runtime), dict_size=64,
                                activation="relu", num_tokens=32 * 3, log_every=1,
                                log_backend="jsonl", checkpoint_dir=str(tmp_path / runtime))
        b = buf.make_buffer(ccfg, cfg, params, corpus, device="cpu")
        logger = MetricsLogger(ccfg)
        tr = Trainer(ccfg, b, logger=logger, device="cpu")
        tr.train()
        rows = [json.loads(line) for line in
                (tmp_path / runtime / "metrics.jsonl").read_text().splitlines()]
        effs = [r.get("harvest/padding_efficiency") for r in rows]
        if runtime == "paged":
            assert effs and all(e is not None and 0.1 < e < 1.0 for e in effs)
        else:
            assert effs and all(e is None for e in effs)

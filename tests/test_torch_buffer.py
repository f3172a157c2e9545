"""The port's replay buffer (crosscoder_tpu_torch/data/buffer.py) against the
JAX package's data/buffer.py.

With the harvest stubbed to hand both packages the same seeded chunks (a
function of the chunk's token ids), every store variant of the port (host
or device store on the CPU, bf16 or int8) must serve a raw stream
BYTE-identical to the JAX buffer of the same variant across two or more
refill cycles: the index bookkeeping is numpy in both, and the int8 path
quantizes bitwise alike. The norm factors reduce in f32 in another order,
so they are held within rel 1e-6 (and the f32 ``next()`` batches, which
multiply by them, too). End to end on the tiny Gemma-2 config with
converted params, the port's harvest goes through its own LM forward and
the store is held against the JAX buffer's within one bf16 ulp (rel 2^-7 at
the bottom of a binade, 2^-8 at its top).
The cases follow tests/test_buffer.py and tests/test_quant.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data.tokens import PAD_ID
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.train import main as tmain

SEQ = 17                     # rows_per_seq = 16
HP = "blocks.2.hook_resid_pre"
VARIANTS = {                 # (buffer_device, quant_buffer) -> JAX class, port class
    "host_bf16": (("host", False), jbuf.PairedActivationBuffer, buf.PairedActivationBuffer),
    "dev_bf16": (("hbm", False), jbuf.DevicePairedActivationBuffer,
                 buf.DevicePairedActivationBuffer),
    "host_int8": (("host", True), jbuf.QuantPairedActivationBuffer,
                  buf.QuantPairedActivationBuffer),
    "dev_int8": (("hbm", True), jbuf.QuantDevicePairedActivationBuffer,
                 buf.QuantDevicePairedActivationBuffer),
}


def make_kw(**kw):
    base = dict(batch_size=32, buffer_mult=32, seq_len=SEQ, d_in=32, n_models=2,
                model_batch_size=4, norm_calib_batches=2, hook_point=HP, seed=3,
                quant_block=16)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def tokens():
    t = np.random.default_rng(7).integers(1, 257, size=(256, SEQ), dtype=np.int64)
    t[5, 12:] = PAD_ID                       # rows ending in pad runs
    t[9, 3:] = PAD_ID
    return t


class Stub:
    """Seeded stand-in harvest: acts[c, s] = E[token] + P[s], bf16-exact."""

    def __init__(self, n_sources, d=32, vocab=257, seed=0):
        rng = np.random.default_rng(seed)
        self.E = rng.normal(size=(vocab, n_sources, d)).astype(np.float32) * 3
        self.P = rng.normal(size=(SEQ, n_sources, d)).astype(np.float32)

    def __call__(self, padded):
        return self.E[np.asarray(padded)] + self.P[None, : padded.shape[1]]


@pytest.fixture
def stubbed(monkeypatch):
    """Install one stub harvest on both packages' buffer classes."""
    def install(n_sources=2):
        stub = Stub(n_sources)
        monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_dev",
                            lambda self, p: jnp.asarray(stub(p)).astype(jnp.bfloat16))
        monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_job",
                            lambda self, p: jbuf._SingleDispatchJob(self._harvest_dev(p)))
        monkeypatch.setattr(jbuf.PairedActivationBuffer, "_segs_per_chunk", lambda self: 1)
        monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_dev",
                            lambda self, p: torch.from_numpy(stub(p)).to(torch.bfloat16))
        monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_job",
                            lambda self, p: buf._SingleDispatchJob(self._harvest_dev(p)))
        monkeypatch.setattr(buf.PairedActivationBuffer, "_segs_per_chunk", lambda self: 1)
        return stub
    return install


def _pair(variant, tokens, lazy=False, **kw):
    (device, qb), jcls, pcls = VARIANTS[variant]
    kw = make_kw(buffer_device=device, quant_buffer=qb, **kw)
    jb = jcls(JCfg(**kw), None, [{}, {}], tokens, lazy=lazy)
    pb = pcls(CrossCoderConfig(**kw), None, [{}, {}], tokens, lazy=lazy, device="cpu")
    return jb, pb


def _raw(x):
    """Bytes of a served raw batch, either package."""
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _assert_same_serves(jb, pb, n):
    for i in range(n):
        np.testing.assert_array_equal(_raw(pb.next_raw()), _raw(jb.next_raw()), err_msg=str(i))
        assert pb.pointer == jb.pointer and pb.token_pointer == jb.token_pointer


@pytest.mark.parametrize("buffer_mult", [32, 33])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_stream_byte_identical_to_jax_across_refills(stubbed, tokens, variant, buffer_mult):
    stubbed()
    jb, pb = _pair(variant, tokens, buffer_mult=buffer_mult)
    np.testing.assert_allclose(pb.normalisation_factor, jb.normalisation_factor, rtol=1e-6)
    np.testing.assert_array_equal(_raw(pb._store), _raw(jb._store))
    if buffer_mult == 33:
        assert pb._cyc_tail == jb._cyc_tail > 0        # the tail-rotation write path
    tp0 = pb.token_pointer
    per_cycle = (pb.buffer_size // 2 - 32) // 32 + 1
    _assert_same_serves(jb, pb, 2 * per_cycle + 3)       # two refill cycles and into a third
    assert pb.token_pointer != tp0
    np.testing.assert_array_equal(_raw(pb._store), _raw(jb._store))
    a, b = pb.next(), np.asarray(jb.next())
    assert a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)
    sj, sp = jb.state_dict(), pb.state_dict()
    assert sp["token_pointer"] == sj["token_pointer"] and sp["rng_state"] == sj["rng_state"]


def test_refill_frac_quarter_matches_jax(stubbed, tokens):
    stubbed()
    jb, pb = _pair("host_bf16", tokens, refill_frac=0.25)
    assert pb._refill_batches() == jb._refill_batches() == 16
    tp0 = pb.token_pointer
    _assert_same_serves(jb, pb, 32)
    assert pb.token_pointer == (tp0 + 2 * 16) % 256


def test_half_refill_cadence(stubbed, tokens):
    """The cycle completes at the trigger (pointer past buffer//2 − batch)
    after harvesting half the sequences between serves; unserved survivors
    keep their bytes, the served region is refilled, no row twice a fill."""
    stubbed()
    _, b = _pair("host_bf16", tokens)
    assert b.token_pointer == 64
    perm_before, store_before = b._perm.copy(), b._store.clone()
    served = []
    for steps in range(1, 17):
        served.append(b._perm[b.pointer: b.pointer + 32].copy())
        b.next_raw()
        if steps < 16:
            assert b.pointer == 32 * steps
        if steps == 14:
            assert b.token_pointer != 64, "harvest was not interleaved with serving"
    assert b.pointer == 0 and b.token_pointer == 96
    survivors, refilled = perm_before[512:], perm_before[:512]
    assert torch.equal(b._store[survivors], store_before[survivors])
    assert not torch.equal(b._store[refilled], store_before[refilled])
    served = np.concatenate(served)
    assert len(np.unique(served)) == len(served) and set(served) <= set(refilled)


@pytest.mark.parametrize("variant", ["host_bf16", "dev_int8"])
def test_resume_rewinds_to_oldest_unserved_row_and_matches_jax(stubbed, tokens, variant):
    stubbed()
    jb, pb = _pair(variant, tokens)
    _assert_same_serves(jb, pb, 20)                      # crosses one refresh
    state = pb.state_dict()
    oldest = int(pb._src_global[pb._perm[pb.pointer:]].min())
    assert state["token_pointer"] == oldest % 256 and oldest < 64
    assert state["token_pointer"] == jb.state_dict()["token_pointer"]
    # a fresh lazy buffer and a live mid-cycle one restore to the same stream
    jr, fresh = _pair(variant, tokens, lazy=True)
    _, live = _pair(variant, tokens)
    for _ in range(6):
        live.next_raw()
    assert live._cyc_seq_done > 0
    jr.load_state_dict(jb.state_dict())
    fresh.load_state_dict(state)
    live.load_state_dict(state)
    assert fresh.token_pointer == live.token_pointer == jr.token_pointer
    np.testing.assert_array_equal(_raw(fresh._store), _raw(live._store))
    for _ in range(3):
        a = _raw(fresh.next_raw())
        np.testing.assert_array_equal(a, _raw(live.next_raw()))
        np.testing.assert_array_equal(a, _raw(jr.next_raw()))


def test_lazy_buffer_and_save_before_first_fill(stubbed, tokens):
    stubbed()
    _, b = _pair("host_bf16", tokens, lazy=True)
    assert b.token_pointer == 0 and not b._filled
    with pytest.raises(RuntimeError, match="lazy"):
        b.next_raw()
    state = b.state_dict()
    assert state["normalisation_factor"] is None
    _, b2 = _pair("host_bf16", tokens, lazy=True)
    b2.load_state_dict(state)
    assert b2._filled and b2.token_pointer == 64
    assert tuple(b2.next_raw().shape) == (32, 2, 32)


def test_token_wraparound(stubbed, tokens):
    stubbed()
    jb, pb = _pair("host_bf16", tokens[:80])
    assert pb.token_pointer == 64
    _assert_same_serves(jb, pb, 16)
    assert pb.token_pointer == (64 + 32) % 80


def test_forced_refresh_mid_cycle_rewinds_like_jax(stubbed, tokens):
    stubbed()
    jb, pb = _pair("host_bf16", tokens)
    _assert_same_serves(jb, pb, 6)
    dispatched = pb._cyc_seq_done
    drained = dispatched - sum(item[1] for item in pb._cyc_inflight)
    assert dispatched > 0 and drained > 0
    tp = pb.token_pointer
    pb.refresh()
    jb.refresh()
    assert pb.token_pointer == jb.token_pointer == (tp - dispatched + 32) % 256
    _assert_same_serves(jb, pb, 4)


@pytest.mark.parametrize("variant", ["dev_bf16", "dev_int8"])
def test_ragged_chunks_drop_padding_rows(stubbed, tokens, variant):
    """model_batch_size 3 does not divide the fills: the device stores get
    padded positions past the store and must drop them."""
    stubbed()
    jb, pb = _pair(variant, tokens, model_batch_size=3)
    _, host = _pair("host_int8" if variant == "dev_int8" else "host_bf16", tokens,
                    model_batch_size=3)
    np.testing.assert_array_equal(_raw(pb._store), _raw(jb._store))
    np.testing.assert_array_equal(_raw(pb._store), _raw(host._store))
    _assert_same_serves(jb, pb, 18)


def test_multi_source_hooks(stubbed, tokens):
    stubbed(n_sources=4)
    hps = ("blocks.1.hook_resid_pre", "blocks.3.hook_resid_pre")
    jb, pb = _pair("dev_bf16", tokens, hook_points=hps)
    assert pb.cfg.n_sources == 4 and tuple(pb._store.shape) == (1024, 4, 32)
    _assert_same_serves(jb, pb, 17)


def test_store_bytes_and_quant_ratio(stubbed, tokens):
    stubbed()
    b16 = {v: _pair(v, tokens)[1] for v in ("host_bf16", "dev_bf16")}
    b8 = {v: _pair(v, tokens)[1] for v in ("host_int8", "dev_int8")}
    want16 = 1024 * 2 * 32 * 2
    assert all(b.store_nbytes() == want16 for b in b16.values())
    for b in b8.values():
        assert b.store_nbytes() == quant.store_bytes((1024, 2, 32), 16)
        assert b.store_nbytes() <= 0.75 * want16            # (1 + 4/16)/2 at block 16
    # the two int8 stores and the two bf16 stores serve the same rows
    np.testing.assert_array_equal(_raw(b8["host_int8"]._store), _raw(b8["dev_int8"]._store))
    np.testing.assert_array_equal(_raw(b16["host_bf16"]._store), _raw(b16["dev_bf16"]._store))


def test_validation(tokens):
    with pytest.raises(ValueError, match="refill_frac"):
        CrossCoderConfig(**make_kw(refill_frac=0.75))
    with pytest.raises(ValueError, match="quant_block"):
        CrossCoderConfig(**make_kw(quant_buffer=True, quant_block=24))
    with pytest.raises(ValueError, match="buffer_device"):
        CrossCoderConfig(**make_kw(buffer_device="disk"))
    with pytest.raises(ValueError, match="raise buffer_mult"):
        buf.PairedActivationBuffer(CrossCoderConfig(**make_kw(buffer_mult=1)), None,
                                   [{}, {}], tokens, device="cpu")
    with pytest.raises(ValueError, match="param sets"):
        buf.PairedActivationBuffer(CrossCoderConfig(**make_kw(n_models=3)), None,
                                   [{}, {}], tokens, device="cpu")
    # seq_shards needs a data axis as wide (one rank here), as the JAX buffer's
    with pytest.raises(ValueError, match="seq_shards 17 != mesh data axis 1"):
        buf.make_buffer(CrossCoderConfig(**make_kw(seq_shards=17)), None, [{}, {}], tokens,
                        device="cpu")
    # the fleet's fan-out is ported: a fleet config builds the store (lazy:
    # no harvest), and the fleet knobs are validated as the JAX config does
    fleet = buf.make_buffer(CrossCoderConfig(**make_kw(fleet="on")), None, [{}, {}], tokens,
                            device="cpu", lazy=True)
    assert fleet.attach_consumer("a") == 0
    with pytest.raises(ValueError, match="fleet_tenants is set but fleet='off'"):
        CrossCoderConfig(**make_kw(fleet_tenants="a"))
    with pytest.raises(ValueError, match="tokens must be"):
        buf.PairedActivationBuffer(CrossCoderConfig(**make_kw()), None, [{}, {}],
                                   tokens[:, :5], device="cpu")


# ---------------------------------------------------------------------------
# end to end: the real tiny-LM harvest on both sides


@pytest.fixture(scope="module")
def lm_pair():
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(i), jcfg) for i in (0, 1)]
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    return jcfg, jparams, lm.LMConfig.tiny(), params


@pytest.mark.parametrize("variant", ["host_bf16", "dev_int8"])
def test_end_to_end_tiny_lm_within_one_bf16_ulp(lm_pair, tokens, variant):
    jcfg, jparams, cfg_lm, params = lm_pair
    (device, qb), jcls, pcls = VARIANTS[variant]
    kw = make_kw(buffer_device=device, quant_buffer=qb)
    jb = jcls(JCfg(**kw), jcfg, jparams, tokens)
    pb = pcls(CrossCoderConfig(**kw), cfg_lm, params, tokens, device="cpu")
    np.testing.assert_allclose(pb.normalisation_factor, jb.normalisation_factor, rtol=1e-5)

    def close(a, b):
        # one bf16 ulp, above the two f32 forwards' own difference (the LM
        # capture's 1e-5 bar, tests/test_torch_lm.py); int8: one quant step
        a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        step = np.abs(b).max() / 127 if qb else 0.0
        np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-5 + step)

    close(pb._store, jb._store)
    for _ in range(18):                                 # across one refill
        close(pb.next_raw(), jb.next_raw())
    # the JAX buffer paces its segmented harvest differently mid-cycle;
    # the stream position it would resume from is the same
    assert pb.state_dict()["token_pointer"] == jb.state_dict()["token_pointer"]


def test_build_buffer_from_token_cache(lm_pair, tmp_path, tokens):
    """train.main.build_buffer composes the local token cache, the model's
    d_in and make_buffer; without LM params it loads each model name as a
    local HF directory, and a name that is not one raises ValueError naming
    it; without a cache FileNotFoundError names the expected path."""
    _, _, cfg_lm, params = lm_pair
    cfg = CrossCoderConfig(**make_kw(d_in=7, data_dir=str(tmp_path), model_names=("a", "b")))
    with pytest.raises(FileNotFoundError, match="pile-lmsys-mix-1m-tokenized-gemma-2.npy"):
        tmain.build_buffer(cfg, device="cpu", model_params=params, lm_cfg=cfg_lm)
    np.save(tmp_path / "pile-lmsys-mix-1m-tokenized-gemma-2.npy", tokens.astype(np.int32))
    b, cfg2 = tmain.build_buffer(cfg, device="cpu", model_params=params, lm_cfg=cfg_lm)
    assert cfg2.d_in == 32 and isinstance(b, buf.PairedActivationBuffer)
    assert tuple(b.next_raw().shape) == (32, 2, 32)
    with pytest.raises(ValueError, match="'google/gemma-2-2b' is not one"):
        tmain.build_buffer(cfg.replace(model_names=("google/gemma-2-2b", "google/gemma-2-2b-it")),
                           device="cpu")

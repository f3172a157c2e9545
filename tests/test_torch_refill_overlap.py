"""The port's refill overlap (crosscoder_tpu_torch/data/buffer.py under
``refill_overlap="on"``: spare rows, the row map, the dispatcher thread)
against overlap off and against the JAX buffer, on all four stores (bf16
and int8, in host RAM and on the device, here the CPU).

The overlap engine swaps indices, never bytes, so overlap on serves the
stream of overlap off bitwise (the JAX package's gate,
tests/test_refill_overlap.py). Against the JAX buffer with overlap on,
both harvests are first replaced by one seeded stand-in (the chunks are
then the same bytes on both sides) and the raw streams must be
byte-identical; with each package's own tiny-LM harvest, the stream is
held within one bf16 ulp (the f32 forwards agree to 1e-5, then each
rounds to bf16; tests/test_torch_buffer.py's bar)."""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train.trainer import Trainer

SEQ = 17                        # 16 rows a sequence
HP = "blocks.2.hook_resid_pre"
STORES = {"host_bf16": ("host", False), "dev_bf16": ("hbm", False),
          "host_int8": ("host", True), "dev_int8": ("hbm", True)}


def _kw(store, **kw):
    device, quant = STORES[store]
    base = dict(batch_size=32, buffer_mult=32, seq_len=SEQ, d_in=32, n_models=2,
                model_batch_size=4, norm_calib_batches=2, hook_point=HP, seed=3,
                buffer_device=device, quant_buffer=quant, quant_block=16)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def models():
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(i), jcfg) for i in (0, 1)]
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    return jcfg, jparams, lm.LMConfig.tiny(), params


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 257, size=(256, SEQ), dtype=np.int64)


def _raw(x):
    if torch.is_tensor(x):
        return x.contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _build(models, tokens, store, **kw):
    _, _, cfg, params = models
    return buf.make_buffer(CrossCoderConfig(**_kw(store, **kw)), cfg, params, tokens,
                           device="cpu")


@pytest.mark.parametrize("store", sorted(STORES))
def test_overlap_on_serves_overlap_off_stream_bitwise(models, tokens, store):
    """40 serves cross two steady-state shadow cycles."""
    off = _build(models, tokens, store)
    on = _build(models, tokens, store, refill_overlap="on")
    try:
        assert on._spare_rows == 512 and on._store_rows == 1024 + 512
        assert on._dispatcher is not None and off._dispatcher is None
        assert on.store_nbytes() == off.store_nbytes() * 1.5
        np.testing.assert_array_equal(on.normalisation_factor, off.normalisation_factor)
        for step in range(40):
            np.testing.assert_array_equal(_raw(on.next_raw()), _raw(off.next_raw()),
                                          err_msg=f"step {step}")
        a, b = on.next(), off.next()
        assert torch.equal(a, b)
    finally:
        on.close()
        off.close()


@pytest.mark.parametrize("store", sorted(STORES))
def test_shadow_swap_rotates_the_row_map(models, tokens, store):
    b = _build(models, tokens, store, refill_overlap="on")
    try:
        assert np.array_equal(b._row_map, np.arange(b.buffer_size))   # the full fill: in place
        for _ in range(16):                       # through the first steady-state cycle
            b.next_raw()
        assert not np.array_equal(b._row_map, np.arange(b.buffer_size))
        occupied = np.concatenate([b._row_map, b._free_rows])         # still a bijection
        assert np.array_equal(np.sort(occupied), np.arange(b._store_rows))
    finally:
        b.close()


@pytest.mark.parametrize("store", sorted(STORES))
def test_mid_cycle_resume_matches_off(models, tokens, store):
    """A snapshot taken mid shadow cycle equals overlap off's (an
    unfinished shadow cycle leaves the provenance untouched), and both
    buffers restored from it serve the same stream."""
    off = _build(models, tokens, store)
    on = _build(models, tokens, store, refill_overlap="on")
    try:
        for _ in range(5):                        # mid-cycle: the trigger is at serve 16
            off.next_raw(), on.next_raw()
        on._quiesce_dispatch()
        state = off.state_dict()
        assert on.state_dict() == state
        off.load_state_dict(state)
        on.load_state_dict(state)
        assert np.array_equal(on._row_map, np.arange(on.buffer_size))
        for step in range(36):
            np.testing.assert_array_equal(_raw(on.next_raw()), _raw(off.next_raw()),
                                          err_msg=f"step {step}")
    finally:
        on.close()
        off.close()


@pytest.mark.parametrize("store", sorted(STORES))
def test_save_drains_the_dispatcher(models, tokens, store, tmp_path):
    """A trainer's save waits for the refill the dispatcher is running (a
    slowed pump here), so the snapshot it writes is not torn; the restore
    quiesces the dispatcher too, and the resumed stream equals a fresh
    buffer restored from the same snapshot."""
    cfg = CrossCoderConfig(**_kw(store, refill_overlap="on"), dict_size=64, activation="relu",
                           num_tokens=32 * 8, checkpoint_dir=str(tmp_path))
    _, _, lm_cfg, params = models
    b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
    pumped = {"start": 0, "end": 0}
    real = b._overlap_pump

    def slow(credit):
        pumped["start"] += 1
        time.sleep(0.05)
        real(credit)
        pumped["end"] += 1

    b._overlap_pump = slow
    tr = Trainer(cfg, b, device="cpu", checkpointer=Checkpointer(cfg=cfg))
    try:
        for _ in range(3):
            tr.step()
        assert b._cyc_shadow
        tr.save()
        d = b._dispatcher
        assert pumped["start"] == pumped["end"] > 0 and d._credit == 0 and not d._busy
        snap = b.state_dict()
        fresh = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu", lazy=True)
        tr2 = Trainer(cfg, fresh, device="cpu", checkpointer=Checkpointer(base_dir=tmp_path))
        tr2.restore()
        assert fresh.state_dict()["token_pointer"] == snap["token_pointer"]
        other = buf.make_buffer(cfg.replace(refill_overlap="off"), lm_cfg, params, tokens,
                                device="cpu", lazy=True)
        other.load_state_dict(snap)
        for step in range(20):
            np.testing.assert_array_equal(_raw(fresh.next_raw()), _raw(other.next_raw()),
                                          err_msg=f"step {step}")
        tr2.close()
    finally:
        tr.close()


def test_dispatcher_error_surfaces_at_the_cycle_end(models, tokens):
    """A harvest error on the dispatcher thread re-raises on the serving
    thread when the cycle completes, not as a dead thread."""
    b = _build(models, tokens, "host_bf16", refill_overlap="on")
    try:
        def broken(padded):
            raise RuntimeError("harvest failed on the dispatcher")

        b._harvest_job = broken
        with pytest.raises(RuntimeError, match="harvest failed on the dispatcher"):
            for _ in range(16):
                b.next_raw()
        assert threading.current_thread() is threading.main_thread()
    finally:
        b.close()
    b.close()                                   # idempotent


class Stub:
    """Seeded stand-in harvest: acts[c, s] = E[token] + P[s], bf16-exact."""

    def __init__(self, n_sources=2, d=32, vocab=257, seed=0):
        rng = np.random.default_rng(seed)
        self.E = rng.normal(size=(vocab, n_sources, d)).astype(np.float32) * 3
        self.P = rng.normal(size=(SEQ, n_sources, d)).astype(np.float32)

    def __call__(self, padded):
        return self.E[np.asarray(padded)] + self.P[None, : padded.shape[1]]


@pytest.mark.parametrize("store", sorted(STORES))
def test_overlap_stream_byte_identical_to_jax_overlap_buffer(monkeypatch, tokens, store):
    stub = Stub()
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
    kw = _kw(store, refill_overlap="on")
    jb = jbuf.make_buffer(JCfg(**kw), None, [{}, {}], tokens)
    pb = buf.make_buffer(CrossCoderConfig(**kw), None, [{}, {}], tokens, device="cpu")
    try:
        np.testing.assert_allclose(pb.normalisation_factor, jb.normalisation_factor, rtol=1e-6)
        for step in range(40):
            np.testing.assert_array_equal(_raw(pb.next_raw()), _raw(jb.next_raw()),
                                          err_msg=f"step {step}")
        jb._quiesce_dispatch()
        pb._quiesce_dispatch()
        sp, sj = pb.state_dict(), jb.state_dict()
        assert sp["token_pointer"] == sj["token_pointer"] and sp["rng_state"] == sj["rng_state"]
        assert np.array_equal(pb._row_map, jb._row_map)
    finally:
        pb.close()
        jb.close()


def test_overlap_stream_against_jax_with_each_harvest(models, tokens):
    """Each package's own harvest of the tiny LM, overlap on: the streams
    agree within one bf16 ulp across two cycles."""
    jcfg, jparams, cfg, params = models
    kw = _kw("host_bf16", refill_overlap="on")
    jb = jbuf.make_buffer(JCfg(**kw), jcfg, jparams, tokens)
    pb = buf.make_buffer(CrossCoderConfig(**kw), cfg, params, tokens, device="cpu")
    try:
        np.testing.assert_allclose(pb.normalisation_factor, jb.normalisation_factor, rtol=1e-5)
        for _ in range(36):
            np.testing.assert_allclose(pb.next_raw().float().numpy(),
                                       np.asarray(jb.next_raw(), np.float32),
                                       rtol=2.0 ** -7, atol=1e-5)
    finally:
        pb.close()
        jb.close()

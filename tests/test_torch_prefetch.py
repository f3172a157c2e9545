"""The trainer's one-deep batch prefetch (``cfg.prefetch``,
``crosscoder_tpu_torch/train/trainer.py``) on the CPU:

- prefetch on against off, BITWISE (losses, metrics, state and the
  stream's position), on one device over the synthetic source, the host
  bf16 store, the host int8 store and the refill-overlap store;
- the port with prefetch on against the JAX ``Trainer`` with prefetch on,
  at the trajectory bar of ``tests/test_torch_trainer.py``;
- a save with a batch in flight, then a restore in a fresh Trainer,
  bitwise the run without the interruption (the save records the stream
  before the batch in flight);
- the loss guard's rollback with prefetch on against off, bitwise;
- on gloo ranks at 2 and 1 × 2, through the mesh store (bf16 and int8,
  ``buffer_device="hbm"``): prefetch on against off, bitwise, with the
  launch sequencer's tickets taken in one order on every rank (one 2-rank
  launch for the file, ``tests/_torch_prefetch_child.py``), as the JAX
  package's ``tests/test_refill_overlap.py:266`` holds its own.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train.trainer import Trainer

from _torch_parallel_child import finish_ranks, start_ranks
from test_torch_resilience import PoisonedSource

SEQ = 17
HP = "blocks.2.hook_resid_pre"
SYN = dict(d_in=16, dict_size=64, batch_size=32, num_tokens=32 * 40, enc_dtype="fp32",
           lr=5e-3, l1_coeff=0.05, log_backend="null", seed=7)
STORES = {"host_bf16": {}, "host_int8": dict(quant_buffer=True, quant_block=16),
          "refill_overlap": dict(refill_overlap="on")}
GRID_TASK = dict(kind="prefetch", grids=[[2, 1], [1, 2]], stores=["bf16", "int8"], steps=8)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The 2-rank launch, started first so the ranks run beside the
    one-device cases."""
    started = start_ranks(2, GRID_TASK, tmp_path_factory.mktemp("prefetch"))
    yield started


@pytest.fixture(scope="module")
def grid(ranks):
    return finish_ranks(ranks)


@pytest.fixture(scope="module")
def models():
    return lm.LMConfig.tiny(), [lm.init_params(lm.LMConfig.tiny(), seed=s, device="cpu")
                                for s in (0, 1)]


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(7).integers(0, 257, size=(256, SEQ), dtype=np.int64)


def _store_cfg(store, **kw):
    return CrossCoderConfig(**{**dict(batch_size=32, buffer_mult=16, seq_len=SEQ, d_in=32,
                                      n_models=2, model_batch_size=4, norm_calib_batches=2,
                                      hook_point=HP, seed=3, dict_size=128,
                                      activation="batchtopk", topk_k=4, l1_coeff=0.0,
                                      log_backend="null"), **STORES[store], **kw})


def _state_equal(a, b):
    for x, y in ((a.params, b.params), (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu), (a.aux or {}, b.aux or {})):
        assert sorted(x) == sorted(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


def _metrics(m):
    return {k: (v.clone() if torch.is_tensor(v) else v) for k, v in m.items()}


def _run(tr, steps):
    out = [_metrics(tr.step(full_metrics=i % 3 == 0)) for i in range(steps)]
    return out


def _same_metrics(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if torch.is_tensor(x[k]):
                assert torch.equal(x[k], y[k]), k
            else:
                assert x[k] == y[k], k


# ---------------------------------------------------------------------------
# on against off, one device


def test_prefetch_on_equals_off_on_the_synthetic_source():
    runs = {}
    for pf in (False, True):
        cfg = CrossCoderConfig(**{**SYN, "l1_coeff": 0.0}, prefetch=pf, activation="topk",
                               topk_k=4, aux_k=8, aux_every=2, aux_dead_steps=2,
                               sparse_bwd="on")
        src = SyntheticActivationSource(cfg)
        tr = Trainer(cfg, src, device="cpu")
        assert (tr._prefetch_pool is not None) == pf and tr._sequencer is None
        metrics = _run(tr, 12)
        tr._drain_prefetch()             # the speculative serve has run
        runs[pf] = (metrics, tr.state, tr._buffer_snapshot, src.counter)
        tr.close()
    _same_metrics(runs[True][0], runs[False][0])
    _state_equal(runs[True][1], runs[False][1])
    # the worker served one batch ahead; its snapshot is the consumed position
    assert runs[True][3] == runs[False][3] + 1
    assert runs[True][2] == {"counter": 12}


@pytest.mark.parametrize("store", sorted(STORES))
def test_prefetch_on_equals_off_on_the_stores(models, tokens, store):
    """10 steps cross a refill of a 512-row store."""
    lm_cfg, params = models
    runs = {}
    for pf in (False, True):
        cfg = _store_cfg(store, prefetch=pf)
        b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
        tr = Trainer(cfg, b, device="cpu")
        runs[pf] = (_run(tr, 10), tr.state)
        if pf:
            tr._drain_prefetch()
            runs[pf] += (tr._buffer_snapshot,)
        else:
            b._quiesce_dispatch()
            runs[pf] += (b.state_dict(),)
        tr.close()
    _same_metrics(runs[True][0], runs[False][0])
    _state_equal(runs[True][1], runs[False][1])
    on, off = runs[True][2], runs[False][2]
    assert on["token_pointer"] == off["token_pointer"]
    assert on["rng_state"] == off["rng_state"]


def test_prefetch_under_a_short_switch_interval_equals_off(models, tokens):
    """Three threads share the refill-overlap store (the step's, the
    prefetch worker, the refill dispatcher), switching every 10 µs: the
    stream, losses and state stay prefetch off's (a lost or reordered
    update of the store's cycle state would change them)."""
    import sys

    lm_cfg, params = models
    runs = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for pf in (False, True):
            cfg = _store_cfg("refill_overlap", prefetch=pf, buffer_mult=8)
            b = buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu")
            tr = Trainer(cfg, b, device="cpu")
            runs[pf] = (_run(tr, 12), tr.state)
            tr.close()
            assert b._dispatcher is None or not b._dispatcher._thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    _same_metrics(runs[True][0], runs[False][0])
    _state_equal(runs[True][1], runs[False][1])


def test_staged_serves_take_two_buffers_in_turn_with_the_sources_bits():
    """The worker's serve of the synthetic source into staging (page-locked
    on the card, plain here): two tensors in turn, each holding the batch
    the source serves at that position, and a subclass whose ``next``
    takes no array is served as it is."""
    cfg = CrossCoderConfig(**SYN, prefetch=True)
    tr, ref = Trainer(cfg, device="cpu"), SyntheticActivationSource(cfg)
    assert tr._serves_into
    got = [tr._serve_staged(i) for i in range(4)]
    assert [g[0].data_ptr() for g in got] == [got[0][0].data_ptr(), got[1][0].data_ptr()] * 2
    assert got[0][0].data_ptr() != got[1][0].data_ptr()
    want = [ref.next() for _ in range(4)]
    for (t, _), w in zip(got[2:], want[2:]):       # each buffer holds its latest batch
        assert torch.equal(t, torch.from_numpy(w))
    tr.close()

    class Plain(SyntheticActivationSource):
        def next(self):
            return super().next()

    tr = Trainer(cfg, Plain(cfg), device="cpu")
    assert not tr._serves_into
    tr.close()


def test_production_runs_on_the_worker_thread():
    cfg = CrossCoderConfig(**SYN, prefetch=True)
    tr = Trainer(cfg, device="cpu")
    seen = []
    real = tr._serve_once

    def serve(*a, **kw):
        seen.append(threading.current_thread().name)
        return real(*a, **kw)

    tr._serve_once = serve
    _run(tr, 3)
    tr.close()
    assert seen and all(n.startswith("batch-prefetch") for n in seen), seen


# ---------------------------------------------------------------------------
# against the JAX trainer with prefetch on


@pytest.mark.parametrize("kw", [dict(activation="topk", topk_k=8, l1_coeff=0.0,
                                     sparse_bwd="on", fused_encoder="off", aux_k=16,
                                     aux_dead_steps=2, aux_every=2)], ids=["topk"])
def test_prefetch_on_matches_jax_prefetch_on_within_the_trainer_bar(kw):
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    try:
        base = dict(d_in=64, n_models=2, dict_size=512, batch_size=32, num_tokens=32 * 8,
                    enc_dtype="fp32", log_backend="null", prefetch=True, seed=7, lr=5e-3,
                    dec_init_norm=0.5, aux_exact_rank=True, **kw)
        jcfg = JCfg(**base)
        mesh = jmesh.make_mesh(devices=jax.devices()[:1])
        jtr = jtrainer.Trainer(jcfg, JSource(jcfg), mesh=mesh)
        assert jtr._prefetch_pool is not None
        state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
        cfg = CrossCoderConfig(**base)
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", state=state)
        assert tr._prefetch_pool is not None
        noise = np.random.default_rng(11).standard_normal((2, 64, 512)).astype(np.float32)
        ctl = jtrainer.Trainer(jcfg, JSource(jcfg), mesh=mesh)
        p = dict(ctl.state.params)
        p["W_enc"] = p["W_enc"] * (1 + 1e-6 * noise)
        ctl.state = jax.device_put(ctl.state._replace(params=p), ctl._state_shardings)
        want = np.array([float(jtr.step()["loss"]) for _ in range(8)])
        got = np.array([float(tr.step()["loss"]) for _ in range(8)])
        control = np.array([float(ctl.step()["loss"]) for _ in range(8)])
        for t in (jtr, ctl, tr):
            t.close()
    finally:
        for m in (jtp, jsg, jfek):
            m.set_interpret(False)
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)


# ---------------------------------------------------------------------------
# save with a batch in flight; the guard's rollback


@pytest.mark.parametrize("source", ["synthetic", "host_bf16"])
def test_save_with_a_batch_in_flight_resumes_bitwise(tmp_path, models, tokens, source):
    """Six steps, a save with batch 7 in flight, a fresh Trainer restores
    and takes four more. The synthetic stream resumes where it stood, so
    the run equals the straight one; a store refills from its oldest
    unserved token when restored, so its run equals the same interruption
    with prefetch off (the save recorded the same position)."""
    lm_cfg, params = models

    def make(pf, **kw):
        if source == "synthetic":
            cfg = CrossCoderConfig(**SYN, prefetch=pf, **kw)
            return cfg, SyntheticActivationSource(cfg)
        cfg = _store_cfg("host_bf16", prefetch=pf, **kw)
        return cfg, buf.make_buffer(cfg, lm_cfg, params, tokens, device="cpu",
                                    lazy=kw.get("resume", False))

    def interrupted(pf):
        d = str(tmp_path / str(pf))
        cfg, src = make(pf)
        first = Trainer(cfg, src, device="cpu", checkpointer=Checkpointer(d))
        got = _run(first, 6)
        assert (first._pending is not None) == pf        # batch 7 in flight at the save
        first.save()
        first.close()
        cfg, src = make(pf, resume=True)
        second = Trainer(cfg, src, device="cpu", checkpointer=Checkpointer(d))
        assert second.step_counter == 6
        got += _run(second, 4)
        second.close()
        return got, second.state

    got, state = interrupted(True)
    if source == "synthetic":
        cfg, src = make(False)
        straight = Trainer(cfg, src, device="cpu")
        want, want_state = _run(straight, 10), straight.state
        straight.close()
    else:
        want, want_state = interrupted(False)
    _same_metrics(got, want)
    _state_equal(state, want_state)


def test_guard_rollback_with_prefetch_on_equals_off(tmp_path):
    """A NaN serve at step 7 trips the guard; the rollback restores the
    save of step 4 (the synthetic stream rewinds, the batch in flight
    dropped) and skips the poisoned serves."""
    runs = {}
    for pf in (False, True):
        d = tmp_path / str(pf)
        cfg = CrossCoderConfig(**{**SYN, "num_tokens": 32 * 14}, prefetch=pf, guard_loss=True,
                               log_every=1, save_every=4, checkpoint_dir=str(d))
        src = PoisonedSource(SyntheticActivationSource(cfg), {7})
        tr = Trainer(cfg, src, device="cpu", checkpointer=Checkpointer(cfg=cfg))
        tr.train()
        runs[pf] = (tr.state, tr.resilience.snapshot(), tr.step_counter, src.inner.counter)
    _state_equal(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1] and runs[False][1]["resilience/rollbacks"] == 1
    assert runs[True][2] == runs[False][2] == 14


def test_sigterm_from_the_worker_leaves_a_save_that_resumes_bitwise(tmp_path):
    """The source signals from inside a serve, which runs on the worker a
    step ahead: ``train()`` stops after a step (which one depends on the
    worker's timing), the final save records the stream before the batch
    in flight, and a Trainer resumed from it ends bitwise the straight run."""
    import os
    import signal

    kw = dict(SYN, num_tokens=32 * 10, prefetch=True)

    class Signals(SyntheticActivationSource):
        def next(self):
            if self.counter == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next()

    cfg = CrossCoderConfig(**kw, checkpoint_dir=str(tmp_path / "a"))
    tr = Trainer(cfg, Signals(cfg), device="cpu", checkpointer=Checkpointer(cfg=cfg))
    tr.train()
    assert 3 <= tr.step_counter < 10
    resumed = Trainer(cfg.replace(resume=True), SyntheticActivationSource(cfg), device="cpu",
                      checkpointer=Checkpointer(cfg=cfg))
    assert resumed.buffer.counter == resumed.step_counter == tr.step_counter
    resumed.train()
    straight = Trainer(CrossCoderConfig(**kw), device="cpu")
    straight.train()
    _state_equal(resumed.state, straight.state)
    # train() serves nothing past its last step
    assert resumed.buffer.counter == straight.buffer.counter == 10


# ---------------------------------------------------------------------------
# gloo ranks through the mesh store


@pytest.mark.parametrize("store", GRID_TASK["stores"])
@pytest.mark.parametrize("grid_", ["2x1", "1x2"])
def test_prefetch_on_equals_off_on_gloo_ranks_through_the_mesh_store(grid, grid_, store):
    for r, res in enumerate(grid):
        on, off = res[f"{grid_} {store} True"], res[f"{grid_} {store} False"]
        assert on["cls"] == off["cls"]
        if grid_ == "2x1":
            assert on["cls"].startswith(("Mesh", "QuantMesh")), on["cls"]
        assert on["losses"] == off["losses"], (r, on["losses"], off["losses"])
        for k in off["params"]:
            np.testing.assert_array_equal(on["params"][k], off["params"][k], err_msg=k)
        assert on["token_pointer"] == off["token_pointer"]
        # tickets: one a production, one a step, the same count on every rank
        assert off["tickets"] is None
        assert on["tickets"] == 2 * GRID_TASK["steps"] + 1
    assert grid[0][f"{grid_} {store} True"]["tickets"] == grid[1][f"{grid_} {store} True"][
        "tickets"]
    assert grid[0][f"{grid_} {store} True"]["losses"] == grid[1][f"{grid_} {store} True"][
        "losses"]

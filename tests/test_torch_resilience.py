"""The port's loss guard and rollback (crosscoder_tpu_torch/train/trainer.py
``_loss_diverged``, ``_rollback``, the retry loop of ``train``) against the
JAX trainer's, which injects its faults through ``resilience/chaos.py``
(``Chaos.parse("nan@N")``: row 0 of serve N all NaN). The port has no
chaos plane; it poisons the same serve through a wrapper source that
counts its serves. Both trainers start from one converted state, so their
serve counts, step counters and ``resilience/*`` counters must be equal,
and the final state is held to the Lyapunov bar of
tests/test_torch_trainer.py in norm: ``‖port − jax‖ ≤ 2‖control − jax‖ +
1e-6‖jax‖`` per leaf, the control being the JAX run from an init whose
W_enc carries 1e-6 relative numpy noise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.resilience.chaos import Chaos
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint.ckpt import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.train import trainer
from crosscoder_tpu_torch.utils.logging import ResilienceCounters


class PoisonedSource:
    """A source whose serves listed in ``nan_serves`` (counted from 0,
    every serve of the wrapper) have row 0 set to NaN; the position it
    checkpoints is the inner source's."""

    def __init__(self, inner, nan_serves):
        self.inner, self.nan_serves, self.serves = inner, set(nan_serves), 0

    def next(self):
        b = np.array(self.inner.next(), copy=True)
        if self.serves in self.nan_serves:
            b[0] = np.nan
        self.serves += 1
        return b

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, d):
        self.inner.load_state_dict(d)


def _kw(tmp_path, steps, **kw):
    return dict(d_in=16, dict_size=64, batch_size=64, num_tokens=64 * steps, enc_dtype="fp32",
                lr=1e-3, l1_coeff=0.1, log_backend="null", prefetch=False,
                checkpoint_dir=str(tmp_path), **kw)


def _jax(kw, chaos, perturb=None):
    cfg = JCfg(**kw)
    tr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                          checkpointer=JCheckpointer(cfg=cfg), chaos=Chaos.parse(chaos))
    if perturb is not None:
        p = dict(tr.state.params)
        p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + perturb))
        tr.state = jax.device_put(tr.state._replace(params=p), tr._state_shardings)
    return tr


def _port(kw, nan_serves, state=None):
    cfg = CrossCoderConfig(**kw)
    return trainer.Trainer(cfg, PoisonedSource(SyntheticActivationSource(cfg), nan_serves),
                           device="cpu", state=state, checkpointer=Checkpointer(cfg=cfg))


def test_loss_diverged_unit_cases():
    cfg = CrossCoderConfig(d_in=8, dict_size=16, guard_loss=True, loss_spike_factor=5.0,
                           enc_dtype="fp32")
    tr = trainer.Trainer(cfg, device="cpu")
    assert not tr._loss_diverged(10.0)       # establishes the reference
    assert not tr._loss_diverged(12.0)       # mild rise: healthy
    assert tr._loss_diverged(float("nan"))
    assert tr._loss_diverged(float("inf"))
    assert tr._loss_diverged(12.0 * 6)       # > factor x last healthy
    assert not tr._loss_diverged(12.0)       # reference unchanged by spikes
    tr._loss_ref = None
    assert not tr._loss_diverged(1e9)        # no reference: any finite loss is healthy


def test_resilience_counters_snapshot():
    c = ResilienceCounters()
    assert c.snapshot() == {}
    c.bump("rollbacks")
    c.bump("skipped_batches", 3)
    c.bump("noop", 0)
    assert c.get("skipped_batches") == 3 and c.get("missing") == 0
    assert c.snapshot() == {"resilience/rollbacks": 1, "resilience/skipped_batches": 3}


def _state_close_to_jax(port_state, jtr, ctl):
    js, cs = jax.device_get(jtr.state), jax.device_get(ctl.state)
    assert port_state.step == int(js.step)
    assert port_state.opt_state.count == int(js.opt_state[1].count)
    for k, w in js.params.items():
        w, c = np.asarray(w, np.float64), np.asarray(cs.params[k], np.float64)
        g = port_state.params[k].double().numpy()
        assert np.isfinite(g).all(), k
        bar = 2 * np.linalg.norm(c - w) + 1e-6 * np.linalg.norm(w)
        assert np.linalg.norm(g - w) <= bar, (k, np.linalg.norm(g - w), bar)


def test_nan_batch_rolls_back_like_jax(tmp_path):
    kw = _kw(tmp_path / "j", 30, log_every=3, save_every=5, guard_loss=True, max_rollbacks=3)
    jtr = _jax(kw, "nan@11")
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    noise = np.random.default_rng(11).standard_normal((2, 16, 64)).astype(np.float32) * 1e-6
    ctl = _jax({**kw, "checkpoint_dir": str(tmp_path / "c")}, "nan@11", perturb=noise)
    tr = _port({**kw, "checkpoint_dir": str(tmp_path / "t")}, {11}, state=state)
    jout, cout, out = jtr.train(), ctl.train(), tr.train()
    assert tr.step_counter == jtr.step_counter == 30
    assert tr.resilience.snapshot() == jtr.resilience.snapshot() == {
        "resilience/rollbacks": 1, "resilience/skipped_batches": 3}
    assert tr._serve_count == jtr._serve_count == tr.buffer.serves
    assert np.isfinite(out["loss"])
    assert abs(out["loss"] - jout["loss"]) <= 2 * abs(cout["loss"] - jout["loss"]) + 1e-6 * abs(
        jout["loss"])
    _state_close_to_jax(tr.state, jtr, ctl)
    # the saves after the restored one were discarded before training went on
    vdir = Checkpointer.latest_version_dir(tmp_path / "t")
    jdir = JCheckpointer.latest_version_dir(tmp_path / "j")
    assert Checkpointer.complete_saves(vdir) == JCheckpointer.complete_saves(jdir)


def test_rollback_budget_exhaustion_raises(tmp_path):
    kw = _kw(tmp_path, 40, log_every=2, save_every=4, guard_loss=True, max_rollbacks=1)
    tr = _port(kw, {9, 25})
    with pytest.raises(RuntimeError, match="rollback budget"):
        tr.train()
    assert tr.resilience.get("rollbacks") == 1


def test_guard_without_checkpointer_raises(tmp_path):
    cfg = CrossCoderConfig(**_kw(tmp_path, 12, log_every=2, guard_loss=True))
    tr = trainer.Trainer(cfg, PoisonedSource(SyntheticActivationSource(cfg), {3}), device="cpu")
    with pytest.raises(RuntimeError, match="no checkpointer"):
        tr.train()


def test_poisoned_newest_save_is_skipped_like_jax(tmp_path):
    """NaN at serve 7 trains into the state of the save after step 8; the
    log at step 10 detects it, the rollback finds that save non-finite,
    counts a poisoned save, lands on the one before and deletes the
    poisoned one."""
    kw = _kw(tmp_path / "j", 20, log_every=5, save_every=3, guard_loss=True, max_rollbacks=2)
    jtr = _jax(kw, "nan@7")
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    tr = _port({**kw, "checkpoint_dir": str(tmp_path / "t")}, {7}, state=state)
    jtr.train()
    tr.train()
    assert tr.resilience.snapshot() == jtr.resilience.snapshot()
    assert tr.resilience.get("poisoned_save_skips") == 1
    assert tr.resilience.get("skipped_batches") == 5      # serves of steps 6..10
    assert tr.step_counter == jtr.step_counter == 20
    assert all(torch.isfinite(v).all() for v in tr.state.params.values())
    vdir = Checkpointer.latest_version_dir(tmp_path / "t")
    jdir = JCheckpointer.latest_version_dir(tmp_path / "j")
    assert Checkpointer.complete_saves(vdir) == JCheckpointer.complete_saves(jdir)


def test_discard_saves_after_truncates_the_branch(tmp_path):
    cfg = CrossCoderConfig(**_kw(tmp_path, 20))
    ck = Checkpointer(cfg=cfg)
    tr = trainer.Trainer(cfg, device="cpu", checkpointer=ck)
    for _ in range(3):
        tr.step()
        tr.save()
    vdir = tmp_path / "version_0"
    ck.discard_saves_after(vdir, 0)
    assert Checkpointer.complete_saves(vdir) == [0]
    assert not (vdir / "2.npz").exists()
    tr2 = trainer.Trainer(cfg, device="cpu", checkpointer=Checkpointer(base_dir=tmp_path))
    assert tr2.restore()["step"] == 1


def test_guard_off_adds_no_sync_and_no_save(tmp_path, monkeypatch):
    """With the guard off the loop syncs once a log step and makes no
    baseline save; the resilience channel stays empty."""
    cfg = CrossCoderConfig(**_kw(tmp_path, 7, log_every=3))
    ck = Checkpointer(cfg=cfg)
    tr = trainer.Trainer(cfg, device="cpu", checkpointer=ck)
    saves = []
    monkeypatch.setattr(ck, "save", lambda *a, **k: saves.append(k.get("background")))
    tr.train()
    assert saves == [True]                   # the final save only
    assert tr.resilience.snapshot() == {}

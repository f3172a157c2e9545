"""Dead-latent resampling in the port (crosscoder_tpu_torch/train/resample.py
and the trainer's call site) against the JAX package's
(crosscoder_tpu/train/resample.py ``make_resample_fn``).

``jax.random.categorical`` cannot be matched draw for draw, so the edit is
held apart from the sampling: the JAX side's categorical is replaced
inside the test by the same row indices the port's edit is handed. Bars:
the edited params, Adam moments and tracker 1e-6 relative (plus 1e-6 of
a leaf's largest value: the residuals come from forwards whose products
sum in another order), the untouched latents and moments bitwise. The
port's own sampling is held to ∝ (row L2 error)² by a chi-square test at
a fixed seed."""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import resample as jresample
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.train import resample, trainer

BASE = dict(d_in=16, dict_size=64, batch_size=32, num_tokens=32 * 200, activation="topk",
            topk_k=4, l1_coeff=0.0, enc_dtype="fp32", resample_every=3, resample_dead_steps=5,
            log_backend="null", seed=3, prefetch=False)
DEAD = [2, 3, 50]


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


def _dead_tracker(H, dead):
    ssf = np.zeros(H, np.int32)
    ssf[dead] = 1000
    return ssf


@pytest.mark.parametrize("kw", [dict(), dict(master_dtype="bf16", enc_dtype="bf16"),
                                dict(resample_enc_scale=1.0, dec_init_norm=0.3)],
                         ids=["f32", "bf16", "scales"])
def test_edit_matches_jax_given_the_same_rows(kw, monkeypatch):
    kw = {**BASE, **kw}
    jtr = jtrainer.Trainer(JCfg(**kw), JSource(JCfg(**kw)),
                           mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    for _ in range(3):
        jtr.step()
    ssf = _dead_tracker(kw["dict_size"], DEAD)
    jtr.state = jtr.state._replace(aux={"steps_since_fired": jnp.asarray(ssf)})
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    batch, scale = jtr._produce_batch()
    ridx = np.random.default_rng(1).integers(0, kw["batch_size"], kw["dict_size"])
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape=None: jnp.asarray(ridx, jnp.int32))
    fn = jresample.make_resample_fn(JCfg(**kw), jtr.mesh, jtr._state_shardings)
    jstate, jn = fn(jtr.state, batch, scale, jax.random.key(0))
    jstate = jax.device_get(jstate)
    cfg = CrossCoderConfig(**kw)
    tb = torch.from_numpy(np.asarray(jax.device_get(batch)).astype(np.float32))
    ts = torch.from_numpy(np.array(jax.device_get(scale)))
    e = resample.residuals(cfg, state, tb, ts)
    new, n = resample.resample_rows(cfg, state, e, torch.from_numpy(ridx))
    assert int(n) == int(jn) == len(DEAD)
    alive = np.setdiff1d(np.arange(kw["dict_size"]), DEAD)
    jadam = jstate.opt_state[1]
    for got, want in ((new.params, jstate.params), (new.opt_state.mu, jadam.mu),
                      (new.opt_state.nu, jadam.nu)):
        for k, w in want.items():
            w = np.asarray(w, np.float32)
            g = got[k].float().numpy()
            assert got[k].dtype == state.params[k].dtype, k
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * np.abs(w).max(), err_msg=k)
    for k, ax in (("W_dec", 0), ("b_enc", 0)):
        for tree, before in ((new.params, state.params), (new.opt_state.mu, state.opt_state.mu)):
            assert torch.equal(tree[k].index_select(ax, torch.from_numpy(alive)),
                               before[k].index_select(ax, torch.from_numpy(alive))), k
    np.testing.assert_array_equal(new.aux["steps_since_fired"].numpy(),
                                  np.asarray(jstate.aux["steps_since_fired"]))
    dec = torch.linalg.norm(new.params["W_dec"][DEAD].float(), dim=-1)
    # bf16 masters round each element: a row norm within 2^-8 relative
    np.testing.assert_allclose(dec.numpy(), cfg.dec_init_norm,
                               rtol=2.0 ** -8 if cfg.master_dtype == "bf16" else 1e-6)
    for moment in (new.opt_state.mu, new.opt_state.nu):
        assert not moment["W_dec"][DEAD].any() and not moment["W_enc"][..., DEAD].any()
        assert not moment["b_enc"][DEAD].any()
    assert not new.params["b_enc"][DEAD].any()
    # the state handed in is untouched
    assert state.aux["steps_since_fired"][DEAD].min() == 1000
    jtr.close()


def test_sampling_follows_squared_row_error():
    gen = torch.Generator().manual_seed(0)
    e = torch.zeros((6, 2, 4))
    err = torch.tensor([0.0, 1.0, 2.0, 0.5, 3.0, 1.5])
    e[:, 0, 0] = err                                   # row error e2 = err²
    draws = torch.cat([resample.sample_rows(e, 5000, gen) for _ in range(20)])
    counts = np.bincount(draws.numpy(), minlength=6)
    w = err.double().numpy() ** 4
    p = w / w.sum()
    assert counts[0] == 0
    exp = p[1:] * counts.sum()
    stat = scipy.stats.chisquare(counts[1:], exp * counts[1:].sum() / exp.sum())
    assert stat.pvalue > 1e-3, (counts, p * counts.sum())


def test_generator_is_seeded_by_step_and_the_edit_reruns_bitwise():
    cfg = CrossCoderConfig(**BASE)
    g1 = resample.resample_generator(cfg, 6, "cpu")
    g2 = resample.resample_generator(cfg, 6, "cpu")
    g3 = resample.resample_generator(cfg, 9, "cpu")
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g3))
    tr = trainer.Trainer(cfg, device="cpu")
    for _ in range(3):
        tr.step()
    tr.state.aux["steps_since_fired"][DEAD] = 1000
    batch = torch.from_numpy(SyntheticActivationSource(cfg).next())
    scale = torch.ones(2)
    fn = resample.make_resample_fn(cfg)
    a, na = fn(tr.state, batch, scale, resample.resample_generator(cfg, 3, "cpu"))
    b, nb = fn(tr.state, batch, scale, resample.resample_generator(cfg, 3, "cpu"))
    assert int(na) == int(nb) == 3
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k])
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])


def test_trainer_resamples_at_the_right_steps():
    cfg = CrossCoderConfig(**{**BASE, "resample_dead_steps": 1, "topk_k": 1, "dict_size": 256})
    tr = trainer.Trainer(cfg, device="cpu")
    got = {}
    for i in range(10):
        m = tr.step()
        if "resampled" in m:
            got[i] = int(m["resampled"])
    assert sorted(got) == [3, 6, 9]
    assert got[3] > 0                     # topk 1 over 32 rows leaves most of 256 latents dead


def test_trainer_resample_matches_jax_call_site(monkeypatch):
    """The trainer's call site, JAX's and the port's from one converted
    state, given the same sampled rows: the step after the resample lands
    on the same params within the edit's bar."""
    kw = {**BASE, "resample_dead_steps": 1, "topk_k": 2}
    jtr = jtrainer.Trainer(JCfg(**kw), JSource(JCfg(**kw)),
                           mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    for _ in range(3):
        jtr.step()
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    cfg = CrossCoderConfig(**kw)
    tr = trainer.Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", state=state)
    tr.buffer.counter = 3
    ridx = np.random.default_rng(2).integers(0, kw["batch_size"], kw["dict_size"])
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape=None: jnp.asarray(ridx, jnp.int32))
    monkeypatch.setattr(resample, "sample_rows", lambda e, n, g: torch.from_numpy(ridx))
    mj, mt = jtr.step(), tr.step()
    assert int(mt["resampled"]) == int(mj["resampled"]) > 0
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
    js = jax.device_get(jtr.state)
    for k, w in js.params.items():
        w = np.asarray(w)
        np.testing.assert_allclose(tr.state.params[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    jtr.close()


def test_resample_composes_with_auxk():
    cfg = CrossCoderConfig(**{**BASE, "aux_k": 8, "aux_dead_steps": 5, "resample_dead_steps": 0})
    assert cfg.resample_threshold_steps == 5
    tr = trainer.Trainer(cfg, device="cpu")
    for _ in range(7):
        m = tr.step()
    assert "dead_frac" in m and np.isfinite(float(m["loss"]))

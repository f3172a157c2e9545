"""The port's Trainer against the JAX package's, from the same converted
state over the same synthetic stream, plus the pieces around it: the
step-variant cadence, the synthetic source, and the CLI entry point.

Trajectory bar (ROADMAP "Parity bars"): at every step, ``|Δloss|`` between
the two trainers is at most twice a Lyapunov control (the JAX trainer
against itself from an init whose W_enc carries 1e-6 relative numpy noise)
plus 1e-6·|loss|. The JAX side runs on one CPU device with its kernels in
interpret mode and exact AuxK ranking. ``dec_init_norm`` 0.5 and lr 5e-3
give the reconstruction a visible share of the loss from the first step,
so both the control and the port's divergence sit above the loss's f32
resolution."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.train import main as tmain
from crosscoder_tpu_torch.train import trainer

STEPS = 20
BASE = dict(d_in=64, n_models=2, dict_size=512, batch_size=32, num_tokens=32 * STEPS,
            enc_dtype="fp32", log_backend="null", prefetch=False, seed=7, lr=5e-3,
            dec_init_norm=0.5, aux_exact_rank=True)
CONFIGS = {
    "relu": dict(activation="relu", l1_coeff=2.0),
    "topk_sparse_auxk": dict(activation="topk", topk_k=8, l1_coeff=0.0, sparse_bwd="on",
                             fused_encoder="off", aux_k=16, aux_dead_steps=2, aux_every=2),
}


@pytest.fixture(autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _jax_trainer(kw, perturb=None):
    cfg = JCfg(**{**BASE, **kw})
    tr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    if perturb is not None:
        p = dict(tr.state.params)
        p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + perturb))
        tr.state = jax.device_put(tr.state._replace(params=p), tr._state_shardings)
    return tr


def _losses(step, n):
    return np.array([float(step()["loss"]) for _ in range(n)])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trajectory_matches_jax_trainer_within_lyapunov_control(name):
    kw = CONFIGS[name]
    jtr = _jax_trainer(kw)
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    cfg = CrossCoderConfig(**{**BASE, **kw})
    tr = trainer.Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", state=state)
    noise = np.random.default_rng(11).standard_normal((2, 64, 512)).astype(np.float32) * 1e-6
    ctl = _jax_trainer(kw, perturb=noise)
    want = _losses(jtr.step, STEPS)
    got = _losses(tr.step, STEPS)
    control = _losses(ctl.step, STEPS)
    jtr.close()
    ctl.close()
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)


def test_step_state_bookkeeping_matches_jax():
    """After 6 AuxK steps both trainers hold the same step, Adam count and
    steps_since_fired tracker."""
    kw = CONFIGS["topk_sparse_auxk"]
    jtr = _jax_trainer(kw)
    cfg = CrossCoderConfig(**{**BASE, **kw})
    tr = trainer.Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                         state=convert.train_state_from_numpy(jax.device_get(jtr.state),
                                                              device="cpu"))
    for _ in range(6):
        mj = jtr.step(full_metrics=False)
        mt = tr.step(full_metrics=False)
    js = jax.device_get(jtr.state)
    assert tr.state.step == int(js.step) == 6 and tr.state.opt_state.count == 6
    np.testing.assert_array_equal(tr.state.aux["steps_since_fired"].numpy(),
                                  np.asarray(js.aux["steps_since_fired"]))
    assert set(mt) == set(mj)
    assert float(mt["dead_frac"]) == pytest.approx(float(mj["dead_frac"]))
    jtr.close()


@pytest.mark.parametrize("kw", [dict(aux_k=16, aux_every=3), dict(aux_k=16, aux_mask_every=4),
                                dict(aux_k=0), dict(aux_k=8, aux_mask_every=0, log_every=5)])
def test_variant_for_step_equals_jax(kw):
    jcfg, cfg = JCfg(**{**BASE, **kw}), CrossCoderConfig(**{**BASE, **kw})
    for s in range(40):
        for full in (True, False):
            assert trainer.variant_for_step(cfg, s, full) == jtrainer.variant_for_step(jcfg, s, full)


def test_synthetic_source_bitwise_equals_jax():
    kw = dict(BASE, batch_size=16, dict_size=256)
    a, b = SyntheticActivationSource(CrossCoderConfig(**kw)), JSource(JCfg(**kw))
    np.testing.assert_array_equal(a.dictionary, b.dictionary)
    for _ in range(3):
        np.testing.assert_array_equal(a.next(), b.next())
    a.load_state_dict({"counter": 1})
    b.load_state_dict({"counter": 1})
    np.testing.assert_array_equal(a.next(), b.next())


def test_main_writes_reference_metrics(tmp_path):
    tr = tmain.main(["--data-source", "synthetic", "--d-in", "32", "--dict-size", "256",
                     "--batch-size", "16", "--num-tokens", "96", "--log-every", "2",
                     "--log-backend", "jsonl", "--checkpoint-dir", str(tmp_path),
                     "--log-print-every", "0"], device="cpu")
    assert tr.state.step == 6
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2, 4]
    want = {"loss", "l2_loss", "l1_loss", "l0_loss", "l1_coeff", "lr", "explained_variance",
            "explained_variance_A", "explained_variance_B", "step_time_ms"}
    assert want <= set(rows[0])
    assert all(np.isfinite(r["loss"]) for r in rows)
    # the gemma source loads local HF directories; a hub name is not one
    with pytest.raises(ValueError, match="'google/gemma-2-2b' is not one"):
        tmain.main(["--data-source", "gemma"], device="cpu")

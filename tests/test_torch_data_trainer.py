"""The port's Trainer over the port's replay buffer against the JAX Trainer
over the JAX buffer, from the same converted train state: a BatchTopK
crosscoder over the bf16 host store, and a ReLU one (the reference's
configuration) over the int8 host and device stores, on paired activations
of two tiny Gemma-2 models.

Both buffers harvest through one shared stand-in (the JAX tiny-LM capture
of each chunk, handed to both packages as the same bf16 bytes), so both
trainers see the same raw stream, crossing refill cycles; the port's own
harvest is held against the JAX one in tests/test_torch_buffer.py. The
norm factors reduce in another order (rel 1e-6). Trajectory bar (ROADMAP
"Parity bars", C2): at every step ``|Δloss|`` is at most twice a Lyapunov
control (the JAX trainer against itself from an init whose W_enc carries
1e-6 relative numpy noise) plus 1e-6·|loss|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.ops import topk_pallas as tp
from crosscoder_tpu_torch.train import trainer

STEPS = 20
SEQ = 17
KW = dict(d_in=32, n_models=2, dict_size=256, batch_size=32, buffer_mult=32, seq_len=SEQ,
          model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
          activation="batchtopk", topk_k=4, l1_coeff=0.0, enc_dtype="fp32",
          num_tokens=32 * STEPS, log_backend="null", prefetch=False, seed=7, lr=5e-3,
          dec_init_norm=0.5)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


@pytest.fixture(scope="module")
def harvest():
    """The shared stand-in harvest: the JAX tiny-LM capture of a chunk."""
    cfg = jlm.LMConfig.tiny()
    params = [jlm.init_params(jax.random.key(i), cfg) for i in (0, 1)]
    cache = {}

    def run(padded):
        key = np.asarray(padded).tobytes()
        if key not in cache:
            acts = jlm.run_with_cache_multi(params, jnp.asarray(padded), cfg, [KW["hook_point"]])
            cache[key] = np.array(acts.astype(jnp.float32))
        return cache[key]
    return run


@pytest.fixture
def stubbed(monkeypatch, harvest):
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_dev",
                        lambda self, p: jnp.asarray(harvest(p)).astype(jnp.bfloat16))
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_job",
                        lambda self, p: jbuf._SingleDispatchJob(self._harvest_dev(p)))
    monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_dev",
                        lambda self, p: torch.from_numpy(harvest(p)).to(torch.bfloat16))
    monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_job",
                        lambda self, p: buf._SingleDispatchJob(self._harvest_dev(p)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(3).integers(1, 257, size=(128, SEQ), dtype=np.int64)


def _jax_trainer(tokens, perturb=None, kw=KW):
    cfg = JCfg(**kw)
    b = jbuf.make_buffer(cfg, jlm.LMConfig.tiny(), [{}, {}], tokens)
    tr = jtrainer.Trainer(cfg, b, mesh=jmesh.make_mesh(devices=jax.devices()[:1]))
    if perturb is not None:
        p = dict(tr.state.params)
        p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + perturb))
        tr.state = jax.device_put(tr.state._replace(params=p), tr._state_shardings)
    return tr


def _trajectories(kw, tokens, steps=STEPS):
    """Loss trajectories of the JAX trainer, the port's trainer from its
    converted state, and the perturbed JAX control, over each package's
    buffer built by ``make_buffer``."""
    jtr = _jax_trainer(tokens, kw=kw)
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    cfg = CrossCoderConfig(**kw)
    pbuf = buf.make_buffer(cfg, lm.LMConfig.tiny(), [{}, {}], tokens, device="cpu")
    tr = trainer.Trainer(cfg, pbuf, device="cpu", state=state)
    np.testing.assert_allclose(pbuf.normalisation_factor, jtr.buffer.normalisation_factor,
                               rtol=1e-6)
    noise = np.random.default_rng(11).standard_normal((2, 32, 256)).astype(np.float32) * 1e-6
    ctl = _jax_trainer(tokens, perturb=noise, kw=kw)
    want = _losses(jtr.step, steps)
    got = _losses(tr.step, steps)
    control = _losses(ctl.step, steps)
    jtr.close()
    ctl.close()
    return got, want, control, tr, jtr


def _losses(step, n):
    return np.array([float(step()["loss"]) for _ in range(n)])


def test_batchtopk_trainer_over_buffer_matches_jax_within_lyapunov_control(stubbed, tokens):
    tp.batchtopk_select.launches = tp.batchtopk_emit.launches = 0
    got, want, control, tr, jtr = _trajectories(KW, tokens)
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)
    # the trainer served raw rows and scaled them by the buffer's factors
    np.testing.assert_array_equal(tr._device_scale().numpy(), tr.buffer.normalisation_factor)
    assert tr.buffer.state_dict()["token_pointer"] == jtr.buffer.state_dict()["token_pointer"]
    assert tp.batchtopk_select.launches == 0                 # CPU: plain versions only


@pytest.mark.parametrize("buffer_device", ["host", "hbm"])
def test_relu_trainer_over_int8_store_matches_jax_within_lyapunov_control(
        stubbed, tokens, buffer_device):
    """The reference's own configuration, ReLU over an int8 store: the
    trainer scales dequantized raw rows by the buffer's factors, as the JAX
    trainer does over the JAX int8 store."""
    kw = dict(KW, activation="relu", quant_buffer=True, quant_block=16,
              buffer_device=buffer_device)
    quant.quantize_rows.launches = 0
    got, want, control, tr, _ = _trajectories(kw, tokens)
    assert type(tr.buffer) is buf.QuantPairedActivationBuffer
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)
    assert quant.quantize_rows.launches == 0                 # CPU: plain version only


def test_relu_int8_first_adam_steps_overshoot_like_jax(stubbed, tokens):
    """With lr times the encoder's fan-in large (2e-2 · 64 here; 1e-3 · 4608
    at Gemma-2-2B width), the first Adam steps, which move every weight by
    about lr whatever its gradient, overshoot: the JAX reference's ReLU loss
    over the int8 store rises at step 2 before it falls, and the port's
    follows it within the bar."""
    kw = dict(KW, activation="relu", quant_buffer=True, quant_block=16, lr=2e-2)
    got, want, control, _, _ = _trajectories(kw, tokens, steps=4)
    assert want[1] > 1.5 * want[0] and want[3] < want[1]
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)


def test_batchtopk_l0_and_eval_threshold(stubbed, tokens):
    """Training keeps at least k·batch latents a batch (ties kept); the
    calibrated threshold then encodes one batch through the fixed-threshold
    mode, whose l0 sits near k."""
    from crosscoder_tpu_torch.models import crosscoder as cc

    cfg = CrossCoderConfig(**KW)
    pbuf = buf.make_buffer(cfg, lm.LMConfig.tiny(), [{}, {}], tokens, device="cpu")
    tr = trainer.Trainer(cfg, pbuf, device="cpu")
    for _ in range(4):
        m = tr.step()
        assert float(m["l0_loss"]) >= cfg.topk_k
    scale = torch.from_numpy(pbuf.normalisation_factor)[None, :, None]
    batches = [pbuf.next_raw().float() * scale for _ in range(2)]
    thr = cc.calibrate_batchtopk_threshold(tr.state.params, cfg, batches)
    assert thr > 0
    f = cc.encode(cc.cast_params(tr.state.params, torch.float32), batches[0],
                  cfg.replace(batchtopk_threshold=thr))
    l0 = float((f > 0).float().sum(-1).mean())
    assert 0 < l0 < 4 * cfg.topk_k

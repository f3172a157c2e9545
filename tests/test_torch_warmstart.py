"""The port's JumpReLU θ warm-start (crosscoder_tpu_torch/train/warmstart.py)
against the JAX package's ``jumprelu_warmstart_params`` on converted
params: the weight leaves carried over unchanged, θ within one f32 ulp
(both calibrate the same BatchTopK threshold; the mean over batches and
``log`` may round an ulp apart), and the three validation errors. A
JumpReLU trainer then steps from the transplant."""

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.train.warmstart import jumprelu_warmstart_params as jwarm
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.train import trainer
from crosscoder_tpu_torch.train.state import Optimizer, TrainState
from crosscoder_tpu_torch.train.warmstart import jumprelu_warmstart_params

K = 8
BASE = dict(d_in=16, dict_size=256, batch_size=64, num_tokens=64 * 200, enc_dtype="fp32",
            log_backend="null", seed=5)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


def _cfgs(enc_dtype="fp32"):
    cfg1 = dict(BASE, activation="batchtopk", topk_k=K, l1_coeff=0.0, enc_dtype=enc_dtype)
    cfg2 = dict(BASE, activation="jumprelu", l1_coeff=0.0, l0_coeff=1.0,
                jumprelu_bandwidth=0.03, enc_dtype=enc_dtype)
    return cfg1, cfg2


@pytest.mark.parametrize("enc_dtype", ["fp32", "bf16"])
def test_warmstart_matches_jax_on_converted_params(enc_dtype):
    k1, k2 = _cfgs(enc_dtype)
    jp = jax.device_get(jcc.init_params(jax.random.key(4), JCfg(**k1), dtype=np.float32))
    src = JSource(JCfg(**k1))
    batches = [src.next() for _ in range(3)]
    want = jax.device_get(jwarm(jp, JCfg(**k1), JCfg(**k2), batches))
    params = convert.crosscoder_params_from_numpy(jp, device="cpu")
    got = jumprelu_warmstart_params(params, CrossCoderConfig(**k1), CrossCoderConfig(**k2),
                                    batches)
    for k in ("W_enc", "W_dec", "b_enc", "b_dec"):
        assert got[k] is params[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    lt, jlt = got["log_theta"].numpy(), np.asarray(want["log_theta"])
    assert lt.dtype == np.float32 and lt.shape == (256,) and (lt == lt[0]).all()
    theta, jtheta = np.exp(lt[:1]), np.exp(jlt[:1])
    assert abs(int(lt[:1].view(np.int32)[0]) - int(jlt[:1].view(np.int32)[0])) <= 1
    assert abs(int(theta.view(np.int32)[0]) - int(jtheta.view(np.int32)[0])) <= 2
    # the transplant starts in the k-sparse regime and trains
    cfg2 = CrossCoderConfig(**k2)
    x = torch.as_tensor(batches[0])
    l0 = float((cc.encode(got, x.float(), cfg2) > 0).float().sum(-1).mean())
    assert K / 4 <= l0 <= 4 * K, l0
    opt = Optimizer(cfg2, lambda s: 0.0)
    tr = trainer.Trainer(cfg2, device="cpu", state=TrainState(got, opt.init(got), 0, None))
    losses = [float(tr.step()["loss"]) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert not torch.equal(tr.state.params["log_theta"], got["log_theta"])


def test_warmstart_validation_errors():
    k1, k2 = _cfgs()
    cfg1, cfg2 = CrossCoderConfig(**k1), CrossCoderConfig(**k2)
    params = cc.init_params(cfg1, device="cpu")
    batches = [np.zeros((4, 2, 16), np.float32) + 1.0]
    with pytest.raises(ValueError, match="cfg_to.activation must be 'jumprelu'"):
        jumprelu_warmstart_params(params, cfg1, cfg1, batches)
    with pytest.raises(ValueError, match="topk|batchtopk"):
        jumprelu_warmstart_params(params, cfg1.replace(activation="relu"), cfg2, batches)
    with pytest.raises(ValueError, match="must match their shapes"):
        jumprelu_warmstart_params(params, cfg1, cfg2.replace(dict_size=128), batches)
    neg = dict(params, b_enc=torch.full((256,), -1e3))
    with pytest.raises(ValueError, match="<= 0"):
        jumprelu_warmstart_params(neg, cfg1, cfg2, batches)

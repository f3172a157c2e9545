"""The port's ``CrossCoderConfig.from_cli``, training-field validation and
schedules against the JAX package's (crosscoder_tpu/config.py,
crosscoder_tpu/train/schedules.py)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from crosscoder_tpu import config as jconfig
from crosscoder_tpu.train import schedules as jsched
from crosscoder_tpu_torch import config
from crosscoder_tpu_torch.train import schedules

ARGVS = [
    [],
    ["--activation", "topk", "--topk-k", "16", "--l1-coeff", "0", "--sparse-bwd", "on",
     "--aux-k", "64", "--aux-every", "2", "--dict-size", "32768", "--batch-size", "4096"],
    ["--hook-points", "blocks.3.hook_resid_pre,blocks.5.hook_resid_pre", "--model-names",
     "a,b", "--resume", "true", "--lr", "1e-4", "--enc-dtype", "fp32", "--remat", "off"],
    ["--data-source", "synthetic", "--num-tokens", "123456", "--master-dtype", "bf16",
     "--fused-encoder", "on", "--activation", "topk", "--l1-coeff", "0"],
]


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:2]) or "defaults")
def test_from_cli_equals_jax(argv):
    mine = config.CrossCoderConfig.from_cli(argv)
    theirs = jconfig.CrossCoderConfig.from_cli(argv)
    assert _fields(mine) == _fields(theirs)
    assert mine.total_steps == theirs.total_steps
    assert mine.aux_mask_cadence == theirs.aux_mask_cadence


def test_from_cli_config_json_and_tuned(tmp_path):
    path = tmp_path / "cfg.json"
    jconfig.CrossCoderConfig(dict_size=1024, activation="topk", l1_coeff=0.0).to_json(path)
    argv = ["--config-json", str(path), "--topk-k", "4"]
    assert _fields(config.CrossCoderConfig.from_cli(argv)) == _fields(
        jconfig.CrossCoderConfig.from_cli(argv))
    # --tuned applies a pinned artifact between the JSON and the flags, as JAX's does
    from crosscoder_tpu_torch.tune.artifact import TunedArtifact

    art = TunedArtifact("train", {"topk_k": 8, "refill_frac": 0.25},
                        {"n_devices": 1, "n_model": 1}).save(tmp_path / "TUNED.json")
    argv = ["--config-json", str(path), "--tuned", str(art), "--topk-k", "4"]
    mine = config.CrossCoderConfig.from_cli(argv)
    assert _fields(mine) == _fields(jconfig.CrossCoderConfig.from_cli(argv))
    assert (mine.topk_k, mine.refill_frac, mine.tuned) == (4, 0.25, str(art))


# the invalid combinations of crosscoder_tpu/config.py's training rules
INVALID = [
    dict(sparse_decode=True),
    dict(factored_decode="sometimes"),
    dict(factored_decode="on"),
    dict(activation="topk", factored_decode="on", l1_coeff=1.0),
    dict(sparse_bwd="maybe"),
    dict(sparse_bwd="on"),
    dict(activation="topk", sparse_bwd="on", l1_coeff=1.0),
    dict(activation="topk", sparse_bwd="on", l1_coeff=0.0, sparse_decode=True),
    dict(fused_encoder="yes"),
    dict(fused_encoder="on"),
    dict(activation="topk", fused_encoder="on", sparse_bwd="off", l1_coeff=0.0),
    dict(activation="topk", fused_encoder="on", l1_coeff=1.0),
    dict(activation="topk", fused_encoder="on", l1_coeff=0.0, sparse_decode=True),
    dict(quant_encoder=True, fused_encoder="off"),
    dict(quant_encoder=True, activation="relu"),
    dict(quant_encoder=True, activation="topk", l1_coeff=0.0, quant_block=100),
    dict(l0_coeff=0.1),
    dict(batchtopk_threshold=0.5),
    dict(aux_k=-1),
    dict(aux_k=100, dict_size=64),
    dict(aux_k=8, aux_dead_steps=0),
    dict(aux_every=0),
    dict(resample_every=-1),
    dict(resample_every=10, aux_dead_steps=0),
    dict(stop_poll_every=0),
    dict(loss_spike_factor=1.0),
    dict(max_rollbacks=-1),
    dict(keep_saves=-2),
    dict(guard_loss=True, keep_saves=1),
    dict(data_source="disk"),
    dict(master_dtype="fp16"),
    dict(log_print_every=-1),
    dict(aux_mask_every=-1),
    dict(quant_block=0),
]


@pytest.mark.parametrize("kw", INVALID, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_invalid_training_fields_raise_in_both(kw):
    with pytest.raises(ValueError):
        jconfig.CrossCoderConfig(**kw)
    with pytest.raises(ValueError):
        config.CrossCoderConfig(**kw)


@pytest.mark.parametrize("kw", [dict(num_tokens=4096 * 40, l1_coeff=2.0),
                                dict(num_tokens=4096 * 7, lr=3e-4, lr_decay_frac=0.5,
                                     l1_warmup_frac=0.3),
                                dict(num_tokens=4096 * 10, l1_warmup_frac=0.0)])
def test_schedules_equal_jax_at_every_step(kw):
    jc, c = jconfig.CrossCoderConfig(**kw), config.CrossCoderConfig(**kw)
    lr_j, l1_j, w_j = jsched.lr_schedule(jc), jsched.l1_coeff_schedule(jc), \
        jsched.sparsity_warmup_schedule(jc)
    lr, l1, w = schedules.lr_schedule(c), schedules.l1_coeff_schedule(c), \
        schedules.sparsity_warmup_schedule(c)
    for s in range(c.total_steps + 3):
        step = jnp.asarray(s, jnp.int32)
        assert np.float32(lr(s)) == np.asarray(lr_j(step), np.float32), s
        assert np.float32(l1(s)) == np.asarray(l1_j(step), np.float32), s
        assert np.float32(w(s)) == np.asarray(w_j(step), np.float32), s
        assert schedules.lr_lambda(s, c) == jsched.lr_lambda(s, jc)
        assert schedules.l1_coeff_at(s, c) == jsched.l1_coeff_at(s, jc)

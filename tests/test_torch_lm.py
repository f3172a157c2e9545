"""The port's Gemma-2 capture runtime (crosscoder_tpu_torch/models/lm.py)
against the JAX package's, with the same weights carried across by
crosscoder_tpu_torch/convert.py: the padded capture forward vs
``run_with_cache_multi`` and the paged capture forward vs
``run_with_cache_multi_paged``, at 1e-5 in fp32 (tiny config, 2 models,
hooks at layers 1 and 3, seq_len 16, pages of 4 and 8)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.data import paging
from crosscoder_tpu_torch.models import lm

HOOKS = ("blocks.1.hook_resid_pre", "blocks.3.hook_resid_pre")
S = 16
TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_xla_attention():
    """The JAX paged path takes its XLA attention unless interpret mode is
    on; pin it off here and for whatever else shares this worker."""
    jpa.set_interpret(False)
    yield
    jpa.set_interpret(False)


@pytest.fixture(scope="module")
def models():
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(s), jcfg) for s in (1, 2)]
    cfg = lm.LMConfig(**dataclasses.asdict(jcfg))
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    return jcfg, jparams, cfg, params


def _tokens(lengths, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 257, size=(len(lengths), S)).astype(np.int32)
    for d, ln in enumerate(lengths):
        tokens[d, ln:] = 0
    return tokens


def test_padded_capture_matches_jax(models):
    jcfg, jparams, cfg, params = models
    tokens = _tokens([S] * 3)
    got = lm.run_with_cache_multi(params, torch.from_numpy(tokens).long(), cfg, HOOKS)
    want = np.asarray(jlm.run_with_cache_multi(jparams, jnp.asarray(tokens), jcfg, HOOKS))
    assert got.shape == (3, S, 4, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("hooks", [HOOKS, ("blocks.2.hook_attn_out", "blocks.0.hook_mlp_out",
                                           "blocks.3.hook_resid_post")])
def test_paged_capture_matches_jax(models, page, hooks):
    jcfg, jparams, cfg, params = models
    lengths = np.array([1, 16, 7, 3, 9, 5, 16, 2])
    tokens = _tokens(lengths, seed=1)
    chunk = paging.pack_chunk(tokens, lengths)
    got = lm.paged_capture(params, chunk, cfg, hooks, page_size=page).numpy()
    want = np.asarray(jlm.run_with_cache_multi_paged(
        jparams, tokens, lengths, jcfg, hooks, page_size=page))
    assert got.shape == want.shape == (8, S, 2 * len(hooks), cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # positions at t >= length are zero, as the JAX zero pad mode makes them
    for d, ln in enumerate(lengths):
        assert not got[d, ln:].any()


def test_paged_matches_padded_at_valid_positions(models):
    _, _, cfg, params = models
    lengths = np.array([S, 4, 11, 1])
    tokens = _tokens(lengths, seed=2)
    paged = lm.paged_capture(params, paging.pack_chunk(tokens, lengths), cfg, HOOKS,
                             page_size=4).numpy()
    padded = lm.run_with_cache_multi(params, torch.from_numpy(tokens).long(), cfg,
                                     HOOKS).numpy()
    for d, ln in enumerate(lengths):
        np.testing.assert_allclose(paged[d, :ln], padded[d, :ln], rtol=TOL, atol=TOL)


def test_hook_layers_and_scan_stop():
    cfg = lm.LMConfig.gemma2_2b()
    pairs = lm._hook_layers(cfg, ("blocks.14.hook_resid_pre",))
    assert pairs == ((14, 0),) and lm._scan_stop(pairs) == 14
    assert lm._scan_stop(lm._hook_layers(cfg, ("blocks.3.hook_mlp_out",))) == 4
    with pytest.raises(ValueError, match="out of range"):
        lm._hook_layers(cfg, ("blocks.27.hook_resid_pre",))
    with pytest.raises(ValueError, match="unsupported hook site"):
        lm._hook_layers(cfg, ("blocks.1.hook_q",))


def test_init_params_layout_matches_jax():
    cfg = lm.LMConfig.tiny()
    params = lm.init_params(cfg, seed=0, device="cpu")
    jparams = jax.eval_shape(lambda k: jlm.init_params(k, jlm.LMConfig.tiny()),
                             jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == tuple(leaf.shape) and t.dtype == torch.float32, path
    again = lm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(params["layers"]["wq"], again["layers"]["wq"])

"""The port's Gemma-2 forward with logits and edits, and its weight
loading (crosscoder_tpu_torch/models/lm.py), against the JAX package's,
the same weights carried across by crosscoder_tpu_torch/convert.py
(tiny fp32 config, 2 sequences of 24 tokens, longer than the sliding
window of 8).

Tolerances: logits 1e-4 absolute; CE and every edit's logits 1e-5;
``from_torch_state_dict`` bitwise against ``convert.lm_params_from_numpy``
of the JAX converter; ``from_hf`` logits against the transformers forward
at 2e-2, as the JAX package's own test holds its loader."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train import main as tmain

S = 24


@pytest.fixture(scope="module")
def pair():
    jcfg = jlm.LMConfig.tiny()
    jparams = jlm.init_params(jax.random.key(7), jcfg)
    # non-zero norm weights, so the (1 + w) scales are exercised too
    rng = np.random.default_rng(0)

    def jitter(x):
        return x + jnp.asarray(rng.normal(0, 0.1, x.shape), x.dtype)

    jparams = dict(jparams, final_norm=jitter(jparams["final_norm"]),
                   layers={k: jitter(v) if k.endswith("norm") else v
                           for k, v in jparams["layers"].items()})
    cfg = lm.LMConfig(**dataclasses.asdict(jcfg))
    params = convert.lm_params_from_numpy(jax.device_get(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, S))
    return jcfg, jparams, cfg, params, tokens


def test_logits_and_ce_match_jax(pair):
    jcfg, jparams, cfg, params, tokens = pair
    got, cache = lm.forward(params, torch.from_numpy(tokens), cfg)
    want, _ = jlm.forward(jparams, jnp.asarray(tokens), jcfg)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab_size) and cache == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    want_ce = float(jlm.loss_fn(want, jnp.asarray(tokens)))
    assert abs(float(lm.loss_fn(got, torch.from_numpy(tokens))) - want_ce) < 1e-5
    assert abs(float(lm.ce_loss(params, tokens, cfg))
               - float(jlm.ce_loss(jparams, jnp.asarray(tokens), jcfg))) < 1e-5


def _edit_cases(rng, d):
    value = rng.normal(0, 1, (2, S, d)).astype(np.float32)
    return {
        "zero resid": [("blocks.2.hook_resid_pre", "zero_edit", None)],
        "splice resid": [("blocks.1.hook_resid_pre", "splice_edit", value)],
        "replace resid_post": [("blocks.3.hook_resid_post", "replace_edit", value)],
        "zero attn_out": [("blocks.1.hook_attn_out", "zero_edit", None)],
        "splice mlp_out": [("blocks.2.hook_mlp_out", "splice_edit", value)],
        "two edits": [("blocks.0.hook_mlp_out", "replace_edit", value * 0.1),
                      ("blocks.2.hook_resid_pre", "splice_edit", value)],
    }


@pytest.mark.parametrize("case", ["zero resid", "splice resid", "replace resid_post",
                                  "zero attn_out", "splice mlp_out", "two edits"])
def test_edits_match_jax_and_capture_sees_the_edit(pair, case):
    jcfg, jparams, cfg, params, tokens = pair
    spec = _edit_cases(np.random.default_rng(2), cfg.d_model)[case]
    hooks = [hp for hp, _, _ in spec]
    edits = [lm.Edit(hp, getattr(lm, fn), None if v is None else torch.from_numpy(v))
             for hp, fn, v in spec]
    jedits = [jlm.Edit(hp, getattr(jlm, fn), None if v is None else jnp.asarray(v))
              for hp, fn, v in spec]
    got, cache = lm.forward(params, torch.from_numpy(tokens), cfg, capture=hooks, edits=edits)
    want, jcache = jlm.forward(jparams, jnp.asarray(tokens), jcfg, capture=hooks, edits=jedits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for hp in hooks:
        np.testing.assert_allclose(cache[hp].numpy(), np.asarray(jcache[hp]), rtol=0,
                                   atol=1e-5)
    clean, _ = lm.forward(params, torch.from_numpy(tokens), cfg)
    assert (got - clean).abs().max() > 1e-3              # every case moves the logits
    hp, fn, v = spec[-1]                                 # the capture sees the edited value
    if fn == "zero_edit":
        assert not cache[hp].any()
    elif fn == "splice_edit":
        torch.testing.assert_close(cache[hp][:, 1:], torch.from_numpy(v)[:, 1:], rtol=0, atol=0)
    assert abs(float(lm.ce_loss(params, tokens, cfg, edits=edits))
               - float(jlm.ce_loss(jparams, jnp.asarray(tokens), jcfg, edits=jedits))) < 1e-5


@pytest.mark.parametrize("hp", ["blocks.2.hook_resid_pre", "blocks.1.hook_attn_out"])
def test_identity_splice_is_a_fixed_point(pair, hp):
    _, _, cfg, params, tokens = pair
    clean, cache = lm.forward(params, tokens, cfg, capture=[hp])
    spliced, _ = lm.forward(params, tokens, cfg,
                            edits=[lm.Edit(hp, lm.splice_edit, cache[hp].float())])
    assert torch.equal(spliced, clean)
    zero = lm.ce_loss(params, tokens, cfg, edits=[lm.Edit(hp, lm.zero_edit)])
    replaced = lm.ce_loss(params, tokens, cfg,
                          edits=[lm.Edit(hp, lm.replace_edit, torch.zeros_like(cache[hp]))])
    assert float(zero) == float(replaced)


def test_run_with_cache_stops_at_the_hook_and_forward_is_differentiable(pair):
    jcfg, jparams, cfg, params, tokens = pair
    hooks = ["blocks.1.hook_resid_pre", "blocks.2.hook_mlp_out"]
    fast = lm.run_with_cache(params, tokens, cfg, hooks)
    _, full = lm.forward(params, tokens, cfg, capture=hooks)
    want = jlm.run_with_cache(jparams, jnp.asarray(tokens), jcfg, hooks)
    for hp in hooks:
        assert torch.equal(fast[hp], full[hp])
        np.testing.assert_allclose(fast[hp].numpy(), np.asarray(want[hp]), rtol=0, atol=1e-5)
    embed = params["embed"].clone().requires_grad_(True)
    logits, _ = lm.forward(dict(params, embed=embed), tokens, cfg)
    lm.loss_fn(logits, tokens).backward()
    assert embed.grad is not None and torch.isfinite(embed.grad).all() and embed.grad.any()


def _hf_state_dict(cfg, rng, dtype=np.float32):
    """A random HF-layout Gemma2 state dict ([out, in] projections)."""
    D, F, qd, kd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "post_attention_layernorm.weight": (D,),
                       p + "pre_feedforward_layernorm.weight": (D,),
                       p + "post_feedforward_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (qd, D), p + "self_attn.k_proj.weight": (kd, D),
                       p + "self_attn.v_proj.weight": (kd, D), p + "self_attn.o_proj.weight": (D, qd),
                       p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D),
                       p + "mlp.down_proj.weight": (D, F)})
    return {k: rng.normal(0, 1, s).astype(dtype) for k, s in shapes.items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


@pytest.mark.parametrize("dtype,as_tensor", [("fp32", False), ("bf16", False), ("bf16", True)])
def test_from_torch_state_dict_bitwise_to_the_jax_converter(dtype, as_tensor):
    cfg = lm.LMConfig.tiny()
    jcfg = jlm.LMConfig.tiny()
    sd = _hf_state_dict(cfg, np.random.default_rng(3))
    if as_tensor:        # a bf16 checkpoint, as transformers loads one
        sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    got = lm.from_torch_state_dict(sd, cfg, dtype=dtype, device="cpu")
    want = convert.lm_params_from_numpy(
        jax.device_get(jlm.from_torch_state_dict(sd, jcfg, dtype=dtype)), device="cpu")
    flat_got = {"embed": got["embed"], "final_norm": got["final_norm"], **got["layers"]}
    flat_want = {"embed": want["embed"], "final_norm": want["final_norm"], **want["layers"]}
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        assert flat_got[k].dtype == flat_want[k].dtype == {"fp32": torch.float32,
                                                            "bf16": torch.bfloat16}[dtype], k
        assert torch.equal(_bits(flat_got[k]), _bits(flat_want[k])), k


def _save_tiny_gemma2(path, seed):
    hf_cfg = transformers.Gemma2Config(
        vocab_size=257, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
        num_key_value_heads=2, head_dim=8, intermediate_size=64, sliding_window=8,
        query_pre_attn_scalar=8.0, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        rope_theta=10_000.0, rms_norm_eps=1e-6,
        # eager attention: sdpa drops the attention logit softcap
        attn_implementation="eager")
    torch.manual_seed(seed)
    model = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    model.save_pretrained(path)
    return model


def test_from_hf_local_checkpoint(tmp_path):
    """Config mapping as the JAX loader's; logits of the bf16 weights taken
    to fp32 against the transformers forward at 2e-2; a name that is not a
    local directory raises before transformers is asked."""
    model = _save_tiny_gemma2(tmp_path / "tiny-gemma2", 0)
    params, cfg = lm.from_hf(str(tmp_path / "tiny-gemma2"), device="cpu")
    _, jcfg = jlm.from_hf(str(tmp_path / "tiny-gemma2"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.d_model == 32 and cfg.n_layers == 4 and cfg.vocab_size == 257
    assert params["embed"].dtype == torch.bfloat16
    tok = np.random.default_rng(3).integers(0, 257, size=(2, 12))
    p32 = convert.lm_params_from_numpy(
        {"embed": params["embed"].float().numpy(), "final_norm": params["final_norm"].float().numpy(),
         "layers": {k: v.float().numpy() for k, v in params["layers"].items()}}, device="cpu")
    logits, _ = lm.forward(p32, tok, dataclasses.replace(cfg, dtype="fp32"))
    with torch.no_grad():
        want = model.float()(torch.from_numpy(tok)).logits.numpy()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=2e-2, atol=2e-2)
    with pytest.raises(ValueError, match="'google/gemma-2-2b' is not one"):
        lm.from_hf("google/gemma-2-2b", device="cpu")


def test_from_hf_tp_loads_each_ranks_slices(tmp_path):
    """``from_hf(..., tp=mesh)`` keeps rank r's tensor-parallel slices of
    every leaf (the ``model`` axis of a 1 × 2 grid, seen from each rank):
    the two ranks' slices concatenate to the whole load, the norms stay
    whole, and the params carry the rank."""
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib

    _save_tiny_gemma2(tmp_path / "tiny-gemma2", 0)
    whole, cfg = lm.from_hf(str(tmp_path / "tiny-gemma2"), device="cpu")
    ranks = [lm.from_hf(str(tmp_path / "tiny-gemma2"), cfg, device="cpu",
                        tp=mesh_lib.Mesh(1, 2, 0, r, None, None, None))[0] for r in (0, 1)]
    specs = lm.tp_shardings(mesh_lib.Mesh(1, 2, 0, 0, None, None, None))
    for r, p in enumerate(ranks):
        assert p[lm.TP_KEY].rank == r
    for key, spec in [("embed", specs["embed"]), ("final_norm", specs["final_norm"]),
                      *[(("layers", k), v) for k, v in specs["layers"].items()]]:
        get = (lambda d: d["layers"][key[1]]) if isinstance(key, tuple) else (lambda d: d[key])
        if spec is None:
            assert all(torch.equal(get(p), get(whole)) for p in ranks), key
        else:
            joined = torch.cat([get(p) for p in ranks], dim=spec[0])
            assert torch.equal(joined, get(whole)), key


def test_train_main_gemma_source_from_two_local_dirs(tmp_path):
    """--data-source gemma loads both --model-names as local HF
    directories and trains over the local token cache."""
    dirs = [tmp_path / "a", tmp_path / "b"]
    for seed, d in enumerate(dirs):
        _save_tiny_gemma2(d, seed)
    tokens = np.random.default_rng(4).integers(1, 257, size=(40, 17)).astype(np.int32)
    np.save(tmp_path / "pile-lmsys-mix-1m-tokenized-gemma-2.npy", tokens)
    ckpt = tmp_path / "ckpt"
    tr = tmain.main(["--data-source", "gemma", "--model-names", f"{dirs[0]},{dirs[1]}",
                     "--data-dir", str(tmp_path), "--seq-len", "17", "--batch-size", "16",
                     "--buffer-mult", "16", "--model-batch-size", "4",
                     "--norm-calib-batches", "1", "--hook-point", "blocks.2.hook_resid_pre",
                     "--dict-size", "64", "--num-tokens", "32", "--log-backend", "null",
                     "--checkpoint-dir", str(ckpt)], device="cpu")
    assert tr.step_counter == 2 and tr.cfg.d_in == 32
    assert np.isfinite(np.asarray(tr.buffer.normalisation_factor)).all()

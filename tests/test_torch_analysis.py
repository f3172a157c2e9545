"""The port's analysis path against the JAX package's, on the CPU: the
decoder statistics (crosscoder_tpu_torch/analysis/decoder.py), the
CE-recovered splicing eval (analysis/ce_eval.py), firing rates, the
dashboards (analysis/dashboards.py, analysis/plots.py), the demo corpus
(demo.py), the in-flight window (utils/pipeline.py) and the replication
walkthrough (replicate.py) and the CE gate (eval_ce.py).

Inputs come from numpy seeds; weights are carried across by
crosscoder_tpu_torch/convert.py (tiny fp32 LMs, a 64-latent crosscoder,
sequences of 24 tokens). The JAX TopK reaches its Pallas kernel in
interpret mode. Tolerances: decoder statistics 1e-6 (counts and masks
equal); CE metrics 1e-4 absolute; firing rates equal; dashboard
activations 1e-5 with features, top sequences, peaks and logit-lens ids
equal; the demo corpus bitwise."""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crosscoder_tpu import demo as jdemo
from crosscoder_tpu.analysis import ce_eval as jce
from crosscoder_tpu.analysis import dashboards as jdash
from crosscoder_tpu.analysis import decoder as jdec
from crosscoder_tpu.analysis import plots as jplots
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.utils import pipeline as jpipeline
from crosscoder_tpu_torch import convert, demo, eval_ce, replicate
from crosscoder_tpu_torch.analysis import ce_eval, dashboards, decoder, plots
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils import pipeline

ROOT = Path(__file__).resolve().parents[1]
HOOK = "blocks.2.hook_resid_pre"
S = 24
CC = dict(d_in=32, n_models=2, dict_size=64, hook_point=HOOK, activation="topk", topk_k=8,
          enc_dtype="fp32", l1_coeff=0.0, log_backend="null")
FACTORS = np.array([0.8, 1.3], np.float32)


@pytest.fixture(autouse=True)
def _interpret_topk():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


@pytest.fixture(scope="module")
def world():
    """Two tiny LMs, a 64-latent TopK crosscoder whose decoder rows are
    scaled per source so that all three relative-norm clusters exist, and
    seeded tokens with BOS (id 2) first."""
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(s), jcfg) for s in (1, 2)]
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    lm_cfg = lm.LMConfig(**dataclasses.asdict(jcfg))
    jccfg, ccfg = JCfg(**CC), CrossCoderConfig(**CC)
    w = jax.device_get(jcc.init_params(jax.random.key(3), jccfg))
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.05, 1.0, (ccfg.dict_size, 2)).astype(np.float32)
    w = dict(w, W_dec=w["W_dec"] * scale[:, :, None],
             b_enc=rng.normal(0, 0.1, w["b_enc"].shape).astype(np.float32))
    ccp = convert.crosscoder_params_from_numpy(w, device="cpu")
    tokens = rng.integers(3, jcfg.vocab_size, size=(5, S))
    tokens[:, 0] = 2
    return dict(jcfg=jcfg, jparams=jparams, lm_cfg=lm_cfg, params=params, jccfg=jccfg,
                ccfg=ccfg, jccp={k: jnp.asarray(v) for k, v in w.items()}, ccp=ccp,
                tokens=tokens)


def test_decoder_statistics_match_jax(world):
    jp, p = world["jccp"], world["ccp"]
    for name in ("decoder_norms", "relative_norms", "cosine_sims"):
        np.testing.assert_allclose(getattr(decoder, name)(p).numpy(),
                                   np.asarray(getattr(jdec, name)(jp)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(decoder.shared_latent_mask(p).numpy(),
                                  np.asarray(jdec.shared_latent_mask(jp)))
    counts, edges = decoder.relative_norm_histogram(p)
    jcounts, jedges = jdec.relative_norm_histogram(jp)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(edges.numpy(), np.asarray(jedges), rtol=0, atol=1e-6)
    r = decoder.relative_norms(p).numpy()
    assert counts.sum() == 64 and (r <= 0.3).any() and (r >= 0.7).any()
    # values on the edges: the last bin is closed on the right, outside is dropped
    edge = {"W_dec": torch.tensor([[[0.0], [1.0]], [[1.0], [0.0]], [[1.0], [1.0]]])}
    got, _ = decoder.relative_norm_histogram(edge, bins=4)
    want, _ = jdec.relative_norm_histogram({"W_dec": jnp.asarray(edge["W_dec"].numpy())}, bins=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _ce_pair(world, kind):
    if kind == "identity":
        return (lambda rows: rows), (lambda rows: rows)
    if kind == "zero":
        return torch.zeros_like, jnp.zeros_like
    folded = cc.fold_scaling_factors(world["ccp"], FACTORS)
    jfolded = jcc.fold_scaling_factors(world["jccp"], jnp.asarray(FACTORS))
    return (ce_eval.crosscoder_reconstruct_fn(folded, world["ccfg"]),
            jce.crosscoder_reconstruct_fn(jfolded, world["jccfg"]))


@pytest.mark.parametrize("kind", ["identity", "zero", "topk"])
def test_ce_recovered_matches_jax(world, kind):
    rec, jrec = _ce_pair(world, kind)
    got = ce_eval.get_ce_recovered_metrics(world["tokens"], world["lm_cfg"], world["params"],
                                           HOOK, rec, chunk=2)
    want = jce.get_ce_recovered_metrics(world["tokens"], world["jcfg"], world["jparams"], HOOK,
                                        jrec, chunk=2)
    assert list(got) == list(want)                   # keys and their order
    for k in got:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])
    if kind == "identity":
        for tag in "AB":
            assert got[f"ce_recovered_{tag}"] == 1.0
            assert got[f"ce_spliced_{tag}"] == got[f"ce_clean_{tag}"]


def test_ce_ragged_tail_counts_every_sequence(world):
    """5 sequences in chunks of 2 (a tail of 1) give the one-chunk means."""
    args = (world["tokens"], world["lm_cfg"], world["params"], HOOK, torch.zeros_like)
    ragged = ce_eval.get_ce_recovered_metrics(*args, chunk=2)
    whole = ce_eval.get_ce_recovered_metrics(*args, chunk=5)
    for k in whole:
        assert abs(ragged[k] - whole[k]) < 1e-5, k
    ces = ce_eval.chunk_ces(world["params"], torch.zeros_like,
                            torch.as_tensor(world["tokens"][:2]), world["lm_cfg"], HOOK)
    assert ces.shape == (2, 3) and ces.dtype == torch.float32


def _rows(world, n=4):
    acts = lm.run_with_cache_multi(world["params"], world["tokens"][:n], world["lm_cfg"], (HOOK,))
    return acts[:, 1:].reshape(-1, 2, 32)


def test_firing_rates_equal_jax(world):
    folded = cc.fold_scaling_factors(world["ccp"], FACTORS)
    jfolded = jcc.fold_scaling_factors(world["jccp"], jnp.asarray(FACTORS))
    batches = [_rows(world)[i:i + 30] for i in range(0, 92, 30)]     # a ragged last batch
    got = decoder.firing_rates(folded, world["ccfg"], batches)
    want = jdec.firing_rates(jfolded, world["jccfg"], [b.numpy() for b in batches])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert decoder.dead_latent_fraction(got) == jdec.dead_latent_fraction(want)
    with pytest.raises(ValueError, match="at least one batch"):
        decoder.firing_rates(folded, world["ccfg"], [])


def test_dashboards_match_jax(world, tmp_path):
    folded = cc.fold_scaling_factors(world["ccp"], FACTORS)
    jfolded = jcc.fold_scaling_factors(world["jccp"], jnp.asarray(FACTORS))
    feats = replicate.pick_features(world["ccp"], k=6)
    assert len(feats) == 6
    vis = dashboards.FeatureVisConfig(hook_point=HOOK, features=feats, minibatch_size_tokens=2,
                                      logit_lens_k=5, n_interval_groups=2, seqs_per_group=2)
    jvis = jdash.FeatureVisConfig(hook_point=HOOK, features=feats, minibatch_size_tokens=2,
                                  logit_lens_k=5, n_interval_groups=2, seqs_per_group=2)
    got = dashboards.FeatureVisData.create(folded, world["ccfg"], world["lm_cfg"],
                                           world["params"], world["tokens"], vis)
    want = jdash.FeatureVisData.create(jfolded, world["jccfg"], world["jcfg"],
                                       world["jparams"], world["tokens"], jvis)
    assert [f.feature for f in got.features] == [f.feature for f in want.features] == feats
    for g, w in zip(got.features, want.features):
        for name in ("max_act", "frac_active", "relative_norm", "cosine_sim"):
            assert abs(getattr(g, name) - getattr(w, name)) < 1e-5, name
        np.testing.assert_allclose(g.acts_sample, w.acts_sample, rtol=0, atol=1e-5)
        for gs, ws in zip(g.top_seqs + [s for grp in g.interval_groups for s in grp["seqs"]],
                          w.top_seqs + [s for grp in w.interval_groups for s in grp["seqs"]]):
            assert gs["tokens"] == ws["tokens"] and gs["peak"] == ws["peak"]
            np.testing.assert_allclose(gs["values"], ws["values"], rtol=0, atol=1e-5)
        assert len(g.top_seqs) == len(w.top_seqs) > 0
        assert [grp["label"] for grp in g.interval_groups] == [grp["label"] for grp in
                                                               w.interval_groups]
        for gl, wl in zip(g.logit_lens, w.logit_lens):
            assert gl["source"] == wl["source"]
            for side in ("promoted", "suppressed"):
                assert [t for t, _ in gl[side]] == [t for t, _ in wl[side]]
                np.testing.assert_allclose([v for _, v in gl[side]], [v for _, v in wl[side]],
                                           rtol=0, atol=1e-5)
    path = got.save_feature_centric_vis(tmp_path / "dashboards.html")
    doc = path.read_text()
    assert doc.count('class="card"') == 6 and "promoted:" in doc and len(doc) > 2000


def test_plots_render_as_jax_and_plotly_is_optional(tmp_path):
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models

    strs, vals, ids = ["a", "<b>", "\n"], [0.0, 2.0, 1.0], [5, 6, 7]
    assert plots.tokens_to_html(strs, vals, token_ids=ids) == jplots.tokens_to_html(
        strs, vals, token_ids=ids)
    assert plots.svg_histogram([0.5, 1.0, 3.0]) == jplots.svg_histogram([0.5, 1.0, 3.0])
    assert plots.default_token_renderer(None)(9) == "⟨9⟩"
    tok = Tokenizer(models.WordLevel({"hello": 0, "world": 1, "[UNK]": 2}, unk_token="[UNK]"))
    tok.save(str(tmp_path / "tokenizer.json"))
    decode, jdecode = plots.decode_fn_from_file(tmp_path), jplots.decode_fn_from_file(tmp_path)
    assert [decode(i) for i in range(3)] == [jdecode(i) for i in range(3)] == ["hello", "world",
                                                                               "[UNK]"]
    for name in ("imshow", "line", "bar", "histogram"):
        with pytest.raises(ImportError, match="plotly is not available"):
            getattr(plots, name)(torch.zeros(3))
    with pytest.raises(ImportError, match="plotly is not available"):
        plots.scatter(torch.zeros(3), torch.zeros(3))


@pytest.mark.parametrize("kw", [{}, dict(seed=12, frac_alt=1.0), dict(seed=13, frac_alt=0.3),
                                dict(n_seqs=7, seq_len=5, vocab=11, seed=0, frac_alt=0.5)])
def test_demo_corpus_bitwise_equal_jax(kw):
    got, want = demo.synthetic_language_tokens(**kw), jdemo.synthetic_language_tokens(**kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
def test_drive_drains_in_order_as_jax(depth):
    log, jlog = [], []

    def produced(out):
        for i in range(7):
            out.append(("put", i))
            yield i

    pipeline.drive(produced(log), lambda i: log.append(("drain", i)), depth=depth)
    jpipeline.drive(produced(jlog), lambda i: jlog.append(("drain", i)), depth=depth)
    assert log == jlog
    assert pipeline.DEFAULT_DEPTH == jpipeline.DEFAULT_DEPTH


def _jax_replicate():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import replicate as jreplicate
    finally:
        sys.path.pop(0)
    return jreplicate


def test_replicate_demo_writes_the_report_and_dashboards(tmp_path):
    """The air-gapped demo at tiny budgets: the report has the keys
    scripts/replicate.py writes, its decoder stage equals the JAX stage on
    the same params, the JAX comparison of the report agrees, and the
    dashboards are written."""
    rep = replicate.main(["--demo", "--demo-lm-steps", "30", "--demo-cc-steps", "20",
                          "--n-seqs", "8", "--out", str(tmp_path)], device="cpu")
    jrep = _jax_replicate()
    report = json.loads((tmp_path / "replicate_report.json").read_text())
    assert set(report) == {"mode", "lm_train_ce", "crosscoder_final", "decoder",
                           "norm_factors", "ce", "firing", "dashboards", "published", "checks"}
    assert report["published"] == jrep.PUBLISHED
    assert set(report["ce"]) == {f"ce_{m}_{t}" for m in ("clean", "zero_abl", "spliced", "diff",
                                                         "recovered") for t in "AB"}
    assert set(report["firing"]) == {"n_rows", "dead_latent_frac", "median_rate", "p95_rate"}
    assert report["firing"]["n_rows"] == 8 * 32
    assert report["checks"] == jrep.compare(report)
    assert len((tmp_path / "dashboards.html").read_text()) == report["dashboards"]["bytes"] > 2000
    assert report["dashboards"]["has_logit_lens"] and report["dashboards"]["cards"] >= 1
    assert np.isfinite(list(report["ce"].values())).all()
    assert rep["mode"].startswith("demo")


def test_replicate_decoder_stage_equals_jax(world):
    got = replicate.decoder_stage(world["ccp"])
    want = _jax_replicate().decoder_stage(world["jccp"])
    assert got.keys() == want.keys()
    for k in got:
        if k == "histogram":
            assert got[k]["counts"] == want[k]["counts"]
            np.testing.assert_allclose(got[k]["edges"], want[k]["edges"], rtol=0, atol=1e-6)
        elif isinstance(got[k], float):
            assert abs(got[k] - want[k]) < 1e-6, k
        else:
            assert got[k] == want[k], k
    assert got["three_clusters_present"]


def test_replicate_version_dir_mode_and_hf_refusal(world, tmp_path):
    """A local checkpoint with two local HF directories, tokens and norm
    factors runs every stage; --hf raises naming what it needs."""
    import transformers

    dirs = []
    for seed in (0, 1):
        hf_cfg = transformers.Gemma2Config(
            vocab_size=257, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=8, intermediate_size=64, sliding_window=8,
            query_pre_attn_scalar=8.0, attn_implementation="eager")
        torch.manual_seed(seed)
        dirs.append(tmp_path / f"m{seed}")
        transformers.Gemma2ForCausalLM(hf_cfg).save_pretrained(dirs[-1])
    cfg = world["ccfg"].replace(checkpoint_dir=str(tmp_path / "ckpt"))
    Trainer(cfg, device="cpu", checkpointer=Checkpointer(cfg=cfg)).save()
    np.save(tmp_path / "tokens.npy", world["tokens"])
    report = replicate.main(
        ["--version-dir", str(Checkpointer.latest_version_dir(tmp_path / "ckpt")),
         "--model-a", str(dirs[0]), "--model-b", str(dirs[1]), "--tokens",
         str(tmp_path / "tokens.npy"), "--norm-factors", "0.5,0.25", "--out",
         str(tmp_path / "out")], device="cpu")
    assert report["mode"] == "local" and report["norm_factors"] == [0.5, 0.25]
    assert np.isfinite(list(report["ce"].values())).all() and report["firing"]["n_rows"] == 5 * 23
    assert (tmp_path / "out" / "dashboards.html").is_file()
    with pytest.raises(NotImplementedError, match="torch_compat.py load_from_hf"):
        replicate.main(["--hf", "--out", str(tmp_path / "hf")], device="cpu")


def test_eval_ce_demo_gate_and_refusals(tmp_path):
    """The air-gapped gate at tiny budgets writes the JAX gate's keys (the
    device in place of the JAX backend), the identity oracle recovers
    exactly 1 and the band is checked only at the default steps; --hf and
    a --version-dir without tokens or factors are refused."""
    out = tmp_path / "ce_gate.json"
    got = eval_ce.main(["--demo", "--demo-lm-steps", "30", "--demo-cc-steps", "20", "--n-seqs",
                        "8", "--out", str(out)], device="cpu")
    saved = json.loads(out.read_text())
    want = set(json.loads((ROOT / "artifacts" / "ce_gate_demo.json").read_text()))
    assert set(saved) == want | {"device", "expected_device"}
    assert saved["oracle_identity_recovered"] == {"A": 1.0, "B": 1.0}
    assert saved["band_checked"] is False and isinstance(got["gate_pass"], bool)
    assert all(saved["oracle_zero_recovered"][m] < 1.0 for m in "AB")
    with pytest.raises(NotImplementedError, match="torch_compat.py load_from_hf"):
        eval_ce.main(["--hf"], device="cpu")
    with pytest.raises(SystemExit):
        eval_ce.main(["--version-dir", str(tmp_path)], device="cpu")
    with pytest.raises(SystemExit, match="--norm-factors a,b is required"):
        eval_ce.main(["--version-dir", str(tmp_path), "--tokens", "t.npy"], device="cpu")

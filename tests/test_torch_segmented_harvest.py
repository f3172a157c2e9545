"""The port's segmented harvest (crosscoder_tpu_torch/models/lm.py
``SegmentedHarvest``) against its own padded capture forward and against
the JAX package's ``SegmentedHarvest``.

Tiny Gemma-2 pair (4 layers), weights carried across by
crosscoder_tpu_torch/convert.py, numpy-seeded tokens. Bars: ``result()``
bitwise equal to the port's ``run_with_cache_multi`` (the same per-layer
ops in the same order, only cut into ranges of blocks), ``step_many(k)``
bitwise equal to k ``step()`` calls with the same quanta accounting, the
pacing ``count`` equal to JAX's, and the result against JAX's at 1e-5 in
f32 (two frameworks' forwards round apart; the same bar as
tests/test_torch_lm.py); the padded buffer, which refills through it, advances
its token stream in step with the JAX buffer at every serve."""

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.models import lm

HOOK_SETS = [
    ("blocks.2.hook_resid_pre",),
    ("blocks.1.hook_resid_pre", "blocks.3.hook_attn_out", "blocks.2.hook_mlp_out"),
    ("blocks.4.hook_resid_pre",),
    ("blocks.0.hook_resid_pre",),
]


@pytest.fixture(scope="module")
def models():
    jcfg = jlm.LMConfig.tiny()
    jparams = [jlm.init_params(jax.random.key(s), jcfg) for s in (11, 12)]
    params = [convert.lm_params_from_numpy(jax.device_get(p), device="cpu") for p in jparams]
    tokens = np.random.default_rng(7).integers(0, jcfg.vocab_size, size=(3, 12))
    return jcfg, jparams, lm.LMConfig.tiny(), params, tokens


@pytest.fixture
def seg(monkeypatch):
    """Set the quantum width on both packages for one test."""
    def set_(k):
        monkeypatch.setattr(lm.SegmentedHarvest, "SEG_LAYERS", k)
        monkeypatch.setattr(jlm.SegmentedHarvest, "SEG_LAYERS", k)
    return set_


@pytest.mark.parametrize("n_layers", [4, 7, 26])
@pytest.mark.parametrize("width", [1, 2, 3, 5])
@pytest.mark.parametrize("hooks", HOOK_SETS, ids=range(len(HOOK_SETS)))
def test_count_matches_jax(seg, n_layers, width, hooks):
    seg(width)
    cfg = lm.LMConfig.tiny(n_layers=n_layers)
    jcfg = jlm.LMConfig.tiny(n_layers=n_layers)
    for n_models in (1, 2):
        assert (lm.SegmentedHarvest.count(cfg, hooks, n_models)
                == jlm.SegmentedHarvest.count(jcfg, hooks, n_models))


def test_seg_layers_reads_the_environment_at_use(monkeypatch):
    monkeypatch.setattr(lm.SegmentedHarvest, "SEG_LAYERS", None)
    monkeypatch.delenv("CROSSCODER_SEG_LAYERS", raising=False)
    assert lm.SegmentedHarvest.seg_layers() == 3
    monkeypatch.setenv("CROSSCODER_SEG_LAYERS", "2")
    assert lm.SegmentedHarvest.seg_layers() == 2
    monkeypatch.setattr(lm.SegmentedHarvest, "SEG_LAYERS", 5)
    assert lm.SegmentedHarvest.seg_layers() == 5


@pytest.mark.parametrize("width", [1, 3])
@pytest.mark.parametrize("hooks", HOOK_SETS, ids=range(len(HOOK_SETS)))
def test_result_bitwise_equals_padded_forward(models, seg, width, hooks):
    seg(width)
    _, _, cfg, params, tokens = models
    want = lm.run_with_cache_multi(params, torch.as_tensor(tokens), cfg, hooks)
    job = lm.SegmentedHarvest(params, tokens, cfg, hooks)
    steps = 1
    while job.step():
        steps += 1
    assert steps == job.n_steps == lm.SegmentedHarvest.count(cfg, hooks, 2)
    assert torch.equal(job.result(), want)
    assert job.result() is job.result() and not job.step()
    bf = lm.SegmentedHarvest(params, tokens, cfg, hooks, out_dtype=torch.bfloat16).result()
    assert torch.equal(bf, want.to(torch.bfloat16))


@pytest.mark.parametrize("k", [2, 3, 1 << 30])
def test_step_many_bitwise_equals_steps(models, seg, k):
    """k quanta a call (straddling the model boundary for k = 3) give the
    narrow loop's result bitwise, and spend exactly its budget."""
    seg(1)
    _, _, cfg, params, tokens = models
    hooks = HOOK_SETS[1]
    narrow = lm.SegmentedHarvest(params, tokens, cfg, hooks)
    while narrow.step():
        pass
    wide = lm.SegmentedHarvest(params, tokens, cfg, hooks)
    total, alive = 0, True
    while alive:
        used, alive = wide.step_many(k)
        assert used >= 1
        total += used
    assert total == wide.n_steps == 8
    assert torch.equal(wide.result(), narrow.result())
    assert wide.step_many(4) == (0, False)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_step_many_accounting_matches_jax(models, seg, k):
    seg(1)
    jcfg, jparams, cfg, params, tokens = models
    hooks = HOOK_SETS[1]
    ours = lm.SegmentedHarvest(params, tokens, cfg, hooks)
    theirs = jlm.SegmentedHarvest(jparams, jax.numpy.asarray(tokens), jcfg, hooks)
    alive = True
    while alive:
        got = ours.step_many(k)
        assert got == theirs.step_many(k)
        alive = got[1]


@pytest.mark.parametrize("hooks", HOOK_SETS[:2], ids=range(2))
def test_result_matches_jax_segmented_harvest(models, seg, hooks):
    seg(3)
    jcfg, jparams, cfg, params, tokens = models
    want = np.asarray(jlm.SegmentedHarvest(jparams, jax.numpy.asarray(tokens), jcfg,
                                           hooks).result(), np.float32)
    got = lm.SegmentedHarvest(params, tokens, cfg, hooks)
    while got.step():
        pass
    np.testing.assert_allclose(got.result().numpy(), want, rtol=1e-5, atol=1e-5)


def test_inflight_names_the_dispatched_tensors(models, seg):
    seg(1)
    _, _, cfg, params, tokens = models
    job = lm.SegmentedHarvest(params, tokens, cfg, HOOK_SETS[0])
    assert job.inflight() == []
    job.step()
    assert len(job.inflight()) == 2                 # the stream and the capture buffer
    while job.step():
        pass
    assert len(job.inflight()) == 1 and job.inflight()[0] is job.result()


@pytest.mark.parametrize("refill_frac", [0.5, 0.25])
def test_padded_buffer_paces_like_jax(models, refill_frac):
    """The padded refill dispatches SegmentedHarvest quanta as the JAX
    buffer does, so the token stream advances in step with JAX's at every
    serve, mid-cycle too (ROADMAP C4's pacing note), and the served
    batches agree within one bf16 ulp (the f32 forwards agree to 1e-5)."""
    from crosscoder_tpu.config import CrossCoderConfig as JCfg
    from crosscoder_tpu.data import buffer as jbuf
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf

    jcfg, jparams, cfg, params, _ = models
    tokens = np.random.default_rng(7).integers(1, 257, size=(256, 17), dtype=np.int64)
    kw = dict(batch_size=32, buffer_mult=32, seq_len=17, d_in=32, n_models=2,
              model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
              seed=3, refill_frac=refill_frac)
    jb = jbuf.make_buffer(JCfg(**kw), jcfg, jparams, tokens)
    pb = buf.make_buffer(CrossCoderConfig(**kw), cfg, params, tokens, device="cpu")
    assert pb._cyc_segs_per_serve == jb._cyc_segs_per_serve
    for i in range(40):
        np.testing.assert_allclose(pb.next_raw().float().numpy(),
                                   np.asarray(jb.next_raw(), np.float32),
                                   rtol=2.0 ** -7, atol=1e-5, err_msg=str(i))
        assert (pb.token_pointer, pb._cyc_seq_done) == (jb.token_pointer, jb._cyc_seq_done), i

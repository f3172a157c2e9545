"""The port's optimizer update (crosscoder_tpu_torch/ops/adam.py through
crosscoder_tpu_torch/train/state.py ``Optimizer``) against the JAX
package's optax chain (crosscoder_tpu/train/state.py ``make_optimizer``:
global-norm clip, Adam, learning rate), and the trainer's donated step
against the functional step body.

Inputs are numpy-seeded leaves with the crosscoder's names and layouts at
a small width, three updates deep, with the gradients scaled so the global
norm sits below or above ``grad_clip``. Bars: f32 masters 1e-6 relative
(the eager ops and XLA's fused chain round the same IEEE steps; XLA-CPU
may contract a multiply-add, a few ulps); bf16 masters three bf16 ulps,
one a step (XLA may keep a fused chain's intermediates in f32 where eager
PyTorch rounds every op to bf16): 3·2^-7 relative, plus 3·2^-7 of the
largest update (3·lr: |m̂/√v̂| stays below 3 over three steps) for the
params and of the leaf's largest value for the moments. The Gemma-2-9B and 27B configs
equal the JAX package's field for field."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.train import state as jstate
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.train import trainer
from crosscoder_tpu_torch.train.state import AdamState, Optimizer

SHAPES = {"W_enc": (2, 8, 48), "W_dec": (48, 2, 8), "b_enc": (48,), "b_dec": (2, 8)}
LR = 3e-3
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _leaves(rng, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _grads_at_norm(rng, norm):
    g = _leaves(rng)
    total = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
    return {k: v * np.float32(norm / total) for k, v in g.items()}


def _to_torch(d, dtype):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in d.items()}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _assert_close(got, want, master, scale):
    """``scale``: the leaves' magnitude a rounding step is taken of (the
    largest update for params, the leaf's largest value for a moment)."""
    for k in SHAPES:
        w = _np(want[k])
        if master == "f32":
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            s = scale if scale is not None else np.abs(w).max()
            np.testing.assert_allclose(_np(got[k]), w, rtol=3 * 2.0 ** -7, atol=3 * 2.0 ** -7 * s,
                                       err_msg=k)


def _run_both(master, norms, donate):
    cfg = CrossCoderConfig(d_in=8, dict_size=48, grad_clip=1.0, beta1=0.9, beta2=0.999)
    tdt, jdt = DTYPES[master]
    rng = np.random.default_rng(11)
    p0 = _leaves(rng, 0.1)
    grads = [_grads_at_norm(rng, n) for n in norms]

    opt = Optimizer(cfg, lambda count: LR)
    params = _to_torch(p0, tdt)
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(_to_torch(g, tdt), state, params, donate=donate)

    tx = jstate.make_optimizer(JCfg(d_in=8, dict_size=48, grad_clip=1.0, beta1=0.9,
                                    beta2=0.999), lambda count: LR)
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v, jdt) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
    jadam = js[1]
    assert state.count == int(jadam.count) == len(grads)
    return (params, state.mu, state.nu), (jp, jadam.mu, jadam.nu)


@pytest.mark.parametrize("master", sorted(DTYPES))
@pytest.mark.parametrize("norms", [(0.5, 0.25, 0.75), (4.0, 2.5, 9.0), (0.5, 3.0, 0.8)],
                         ids=["below_clip", "above_clip", "both_sides"])
def test_plain_update_matches_jax_optax_chain(master, norms):
    got, want = _run_both(master, norms, donate=False)
    for g, w, scale in zip(got, want, (3 * LR, None, None)):
        _assert_close(g, w, master, scale)


@pytest.mark.parametrize("master", sorted(DTYPES))
def test_donated_update_matches_jax_optax_chain(master):
    got, want = _run_both(master, (0.5, 3.0, 0.8), donate=True)
    for g, w, scale in zip(got, want, (3 * LR, None, None)):
        _assert_close(g, w, master, scale)


@pytest.mark.parametrize("master", sorted(DTYPES))
def test_donated_update_writes_in_place_and_functional_keeps_inputs(master):
    tdt = DTYPES[master][0]
    cfg = CrossCoderConfig(d_in=8, dict_size=48)
    opt = Optimizer(cfg, lambda count: LR)
    rng = np.random.default_rng(5)
    params = _to_torch(_leaves(rng, 0.1), tdt)
    grads = _to_torch(_grads_at_norm(rng, 2.0), tdt)
    state = AdamState(3, _to_torch(_leaves(rng, 0.01), tdt),
                      _to_torch({k: np.abs(v) for k, v in _leaves(rng, 0.01).items()}, tdt))
    before = [{k: v.clone() for k, v in d.items()} for d in (params, state.mu, state.nu)]
    new_p, new_s = opt.update(grads, state, params)
    for d, b in zip((params, state.mu, state.nu), before):        # functional: untouched
        for k in d:
            assert torch.equal(d[k], b[k])
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    don_p, don_s = opt.update(grads, state, params, donate=True)
    assert all(don_p[k].data_ptr() == ptrs[k] for k in ptrs)       # in place
    assert don_s.mu is state.mu and don_s.nu is state.nu and don_s.count == new_s.count == 4
    for a, b in zip((don_p, don_s.mu, don_s.nu), (new_p, new_s.mu, new_s.nu)):
        for k in a:
            assert torch.equal(a[k].view(torch.int16 if master == "bf16" else torch.int32),
                               b[k].view(torch.int16 if master == "bf16" else torch.int32)), k


def test_update_never_syncs_the_host(monkeypatch):
    """The clip is chosen on the device: nothing in an update turns a
    tensor into a Python bool or number."""
    cfg = CrossCoderConfig(d_in=8, dict_size=48)
    opt = Optimizer(cfg, lambda count: LR)
    rng = np.random.default_rng(2)
    params = _to_torch(_leaves(rng, 0.1), torch.float32)
    state = opt.init(params)

    def refuse(self, *a):
        raise AssertionError("host sync in the optimizer update")

    for name in ("__bool__", "item", "__float__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for n in (0.5, 4.0):
        params, state = opt.update(_to_torch(_grads_at_norm(rng, n), torch.float32), state,
                                   params, donate=True)
    monkeypatch.undo()
    assert all(torch.isfinite(v).all() for v in params.values())


@pytest.mark.parametrize("norm", [0.5, 4.0])
def test_adam_update_plain_matches_per_leaf_op_sequence(norm):
    """The plain version is the optimizer's op sequence, leaf by leaf, with
    the clip taken by ``torch.where``: bitwise the branchy form."""
    rng = np.random.default_rng(9)
    params = _to_torch(_leaves(rng, 0.1), torch.float32)
    grads = _to_torch(_grads_at_norm(rng, norm), torch.float32)
    mu = _to_torch(_leaves(rng, 0.01), torch.float32)
    nu = _to_torch({k: np.abs(v) for k, v in _leaves(rng, 0.01).items()}, torch.float32)
    n = Optimizer.global_norm(grads)
    out = tuple({k: torch.empty_like(v) for k, v in params.items()} for _ in range(3))
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=float(np.float32(0.271)),
              bc2=float(np.float32(0.003)), step_size=-LR)
    adam.adam_update_plain(params, grads, mu, nu, n, out=out, **kw)
    for k in params:
        g = grads[k] if norm < 1.0 else (grads[k] / n) * 1.0
        m = (1 - 0.9) * g + 0.9 * mu[k]
        v = (1 - 0.999) * torch.square(g) + 0.999 * nu[k]
        u = (m / torch.tensor(kw["bc1"])) / (torch.sqrt(v / torch.tensor(kw["bc2"])) + 1e-8)
        p = params[k] + torch.tensor(np.float32(-LR)) * u
        assert torch.equal(out[0][k], p) and torch.equal(out[1][k], m) and torch.equal(out[2][k], v)
    assert adam.adam_update.launches == 0


KW = dict(d_in=16, n_models=2, dict_size=64, batch_size=16, num_tokens=16 * 6,
          activation="topk", topk_k=4, l1_coeff=0.0, enc_dtype="fp32", log_backend="null",
          prefetch=False, seed=3, lr=5e-3, aux_k=8, aux_every=2, aux_dead_steps=2,
          fused_encoder="off")


@pytest.mark.parametrize("master", ["fp32", "bf16"])
def test_trainer_step_donates_and_equals_functional_step_fn(master):
    """The trainer's steps (the first copies the state it was handed, the
    rest update its own state in place) equal the functional step body run
    on the same batches, bitwise; the handed-in state stays intact."""
    cfg = CrossCoderConfig(**KW, master_dtype=master)
    batches = [torch.from_numpy(SyntheticActivationSource(cfg).next()) for _ in range(4)]

    class Replay:
        i = 0

        def next(self):
            self.i += 1
            return batches[self.i - 1]

    tr0 = trainer.Trainer(cfg, Replay(), device="cpu")
    handed = tr0.state
    snap = {k: v.clone() for k, v in handed.params.items()}
    tr = trainer.Trainer(cfg, Replay(), device="cpu", state=handed)
    ptrs = None
    for i in range(4):
        tr.step()
        if i == 1:
            ptrs = {k: v.data_ptr() for k, v in tr.state.params.items()}
    assert all(tr.state.params[k].data_ptr() == ptrs[k] for k in ptrs)   # donated steps
    assert all(torch.equal(handed.params[k], snap[k]) for k in snap)

    state = handed
    scale = torch.ones(cfg.n_sources)
    for i, b in enumerate(batches):
        fn = trainer.make_step_body(cfg, Optimizer(cfg, trainer.schedules.lr_schedule(cfg)),
                                    *trainer.variant_for_step(cfg, i))
        state, _ = fn(state, b, scale)
    assert all(torch.equal(handed.params[k], snap[k]) for k in snap)     # functional
    for a, b in ((tr.state.params, state.params), (tr.state.opt_state.mu, state.opt_state.mu),
                 (tr.state.opt_state.nu, state.opt_state.nu)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(tr.state.aux["steps_since_fired"], state.aux["steps_since_fired"])


@pytest.mark.parametrize("name", ["gemma-2-9b", "gemma-2-9b-it", "gemma-2-27b",
                                  "google/gemma-2-27b-it", "gemma-2-2b"])
def test_gemma2_configs_match_jax(name):
    assert dataclasses.asdict(lm.config_for(name)) == dataclasses.asdict(jlm.config_for(name))


def test_gemma2_27b_query_scale_is_not_head_dim():
    c = lm.LMConfig.gemma2_27b()
    assert c.query_pre_attn_scalar == 144.0 == c.d_model / c.n_heads != c.head_dim
    assert dataclasses.asdict(lm.LMConfig.gemma2_9b()) == dataclasses.asdict(
        jlm.LMConfig.gemma2_9b())

"""JumpReLU in the port (crosscoder_tpu_torch/ops/activations.py
``jumprelu``/``jumprelu_l0``, the crosscoder's ``log_theta`` surface, the
trainer's L0 warmup, saves, and the optimizer update over an f32
``log_theta`` beside bf16 masters) against the JAX package's.

Inputs are numpy-seeded. ``exp`` of one f32 ``log_theta`` may differ by an
ulp between XLA-CPU and PyTorch, which moves θ and flips the mask on
entries within an ulp of it; the element-level tests take their
``log_theta`` values where both packages' ``exp`` agree, so θ is the same
bits on both sides and entries planted exactly at θ and at θ ± ε/2 test
the strict comparison and the inclusive rectangle. Bars: the forward and
``dh`` exact; ``dlog_theta`` 1e-6 relative (sums over the batch in another
order), plus 1e-6 of the largest entry where an entry's terms cancel; the
L0 value and the losses 1e-6 relative (XLA divides a mean by multiplying
with the reciprocal, an ulp from PyTorch's division); the trainer trajectory under the
Lyapunov bar of tests/test_torch_trainer.py."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import activations as jact
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import state as jstate
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import ckpt
from crosscoder_tpu_torch.checkpoint.ckpt import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import activations as act
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.train import trainer
from crosscoder_tpu_torch.train.state import Optimizer

BW = 0.03
DT = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _agreeing_log_theta(rng, n):
    """``n`` f32 log-thresholds around log(0.1) whose exp is the same bits
    in XLA-CPU and PyTorch."""
    cand = (np.log(0.1) + 0.5 * rng.standard_normal(8 * n)).astype(np.float32)
    same = (np.asarray(jnp.exp(cand)).view(np.int32)
            == torch.exp(torch.from_numpy(cand)).numpy().view(np.int32))
    assert same.sum() >= n
    return cand[same][:n]


def _planted(rng, lt, tdt, jdt, B=48):
    """Pre-activations ``[B, H]`` in the compute dtype with, per latent,
    entries exactly at θ, at θ ± ε/2 and one ulp either side of θ."""
    H = lt.shape[0]
    theta = torch.exp(torch.from_numpy(lt)).to(tdt)
    h = torch.from_numpy((0.1 + 0.08 * rng.standard_normal((B, H))).astype(np.float32)).to(tdt)
    tf = theta.float()
    up = torch.nextafter(theta, torch.full_like(theta, 1.0))
    dn = torch.nextafter(theta, torch.full_like(theta, 0.0))
    for r, row in enumerate([theta, (tf + BW / 2).to(tdt), (tf - BW / 2).to(tdt), up, dn]):
        h[r] = row
    return h


def _sum_atol(want):
    """A batch sum's rounding, taken of the largest sum: an entry whose
    terms cancel keeps the rounding of its terms, not of its value."""
    return 1e-6 * float(np.abs(np.asarray(want)).max())


def _j(t, jdt):
    return jnp.asarray(t.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_jumprelu_forward_and_both_gradients_match_jax(dtype):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(0)
    lt = _agreeing_log_theta(rng, 40)
    h = _planted(rng, lt, tdt, jdt)
    g = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32)).to(tdt)
    ht = h.clone().requires_grad_(True)
    ltt = torch.from_numpy(lt).requires_grad_(True)
    out = act.jumprelu(ht, ltt, BW)
    dh, dlt = torch.autograd.grad(out, [ht, ltt], g)
    jout, vjp = jax.vjp(lambda a, b: jact.jumprelu(a, b, BW), _j(h, jdt), jnp.asarray(lt))
    jdh, jdlt = vjp(_j(g, jdt))
    assert out.dtype == tdt and dh.dtype == tdt and dlt.dtype == torch.float32
    np.testing.assert_array_equal(out.detach().float().numpy(), np.asarray(jout, np.float32))
    np.testing.assert_array_equal(dh.float().numpy(), np.asarray(jdh, np.float32))
    np.testing.assert_allclose(dlt.numpy(), np.asarray(jdlt), rtol=1e-6, atol=_sum_atol(jdlt))
    # the planted rows: strict at θ, inclusive rectangle at θ ± ε/2
    assert (out[0] == 0).all() and (out[3] != 0).all()
    assert (dlt != 0).any()


@pytest.mark.parametrize("dtype", sorted(DT))
def test_jumprelu_l0_and_its_gradient_match_jax(dtype):
    tdt, jdt = DT[dtype]
    rng = np.random.default_rng(1)
    lt = _agreeing_log_theta(rng, 32)
    h = _planted(rng, lt, tdt, jdt)
    ht = h.clone().requires_grad_(True)
    ltt = torch.from_numpy(lt).requires_grad_(True)
    val = act.jumprelu_l0(ht, ltt, BW)
    dh, dlt = torch.autograd.grad(val * 1.7, [ht, ltt])
    jval, vjp = jax.vjp(lambda a, b: jact.jumprelu_l0(a, b, BW), _j(h, jdt), jnp.asarray(lt))
    jdh, jdlt = vjp(jnp.float32(1.7))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-6)
    assert not dh.any() and not np.asarray(jdh, np.float32).any()
    np.testing.assert_allclose(dlt.numpy(), np.asarray(jdlt), rtol=1e-6, atol=_sum_atol(jdlt))


def test_apply_dispatches_jumprelu_and_needs_log_theta():
    cfg = CrossCoderConfig(d_in=8, dict_size=16, enc_dtype="fp32", activation="jumprelu",
                           jumprelu_theta=0.05)
    h = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="log_theta"):
        act.apply(h, cfg)
    with pytest.raises(ValueError, match="log_theta"):
        act.apply(h, cfg, {"W_enc": h})
    lt = torch.full((16,), float(np.log(np.float32(0.05))))
    assert torch.equal(act.apply(h, cfg, {"log_theta": lt}),
                       act.jumprelu(h, lt, cfg.jumprelu_bandwidth))


@pytest.mark.parametrize("theta", [0.001, 0.01, 0.0372, 0.5])
@pytest.mark.parametrize("enc_dtype", ["fp32", "bf16"])
def test_init_params_log_theta_bitwise_and_param_count(theta, enc_dtype):
    cfg = CrossCoderConfig(d_in=8, dict_size=32, activation="jumprelu", jumprelu_theta=theta,
                           enc_dtype=enc_dtype)
    p = cc.init_params(cfg, seed=0, device="cpu")
    jp = jcc.init_params(jax.random.key(0), JCfg(**cfg.to_dict()))
    assert p["log_theta"].dtype == torch.float32 and p["W_enc"].dtype == cc.dtype_of(enc_dtype)
    np.testing.assert_array_equal(p["log_theta"].numpy().view(np.int32),
                                  np.asarray(jp["log_theta"]).view(np.int32))
    assert cc.param_count(cfg) == jcc.param_count(JCfg(**cfg.to_dict())) == sum(
        v.numel() for v in p.values())
    assert "log_theta" in dict(cc.CrossCoder(p, cfg).named_parameters())
    assert "log_theta" not in cc.init_params(cfg.replace(activation="relu"), device="cpu")


def _loss_case(rng, enc_dtype, l0_coeff):
    kw = dict(d_in=16, n_models=2, dict_size=64, activation="jumprelu", jumprelu_theta=0.05,
              jumprelu_bandwidth=BW, l0_coeff=l0_coeff, l1_coeff=0.3, enc_dtype=enc_dtype)
    cfg = CrossCoderConfig(**kw)
    jp = jcc.init_params(jax.random.key(3), JCfg(**kw), dtype=jnp.float32)
    # log_theta must exp to the same bits in both packages
    lt = _agreeing_log_theta(rng, 64)
    jp = {**jax.device_get(jp), "log_theta": lt}
    jp["b_enc"] = (0.05 * rng.standard_normal(64)).astype(np.float32)
    x = (0.5 * rng.standard_normal((32, 2, 16))).astype(np.float32)
    return cfg, JCfg(**kw), jp, x


@pytest.mark.parametrize("enc_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("l0_coeff", [0.0, 0.7])
def test_get_losses_and_training_loss_match_jax(enc_dtype, l0_coeff):
    cfg, jcfg, jp, x = _loss_case(np.random.default_rng(2), enc_dtype, l0_coeff)
    params = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    loss, losses = cc.training_loss(params, torch.from_numpy(x), 0.3, cfg, l0_coeff=0.45)
    grads = torch.autograd.grad(loss, list(params.values()))
    (jloss, jlosses), jgrads = jax.value_and_grad(
        lambda p: jcc.training_loss(p, jnp.asarray(x), 0.3, jcfg, l0_coeff=0.45),
        has_aux=True)({k: jnp.asarray(v) for k, v in jp.items()})
    rtol = 1e-6 if enc_dtype == "fp32" else 1e-2
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=rtol)
    for name in ("l2_loss", "l1_loss", "l0_loss", "l0_penalty"):
        np.testing.assert_allclose(float(torch.as_tensor(getattr(losses, name)).detach()),
                                   float(getattr(jlosses, name)),
                                   rtol=rtol, err_msg=name)
    if l0_coeff == 0:
        assert losses.l0_penalty == 0.0
    else:
        assert float(losses.l0_penalty.detach()) == float(losses.l0_loss.detach())
    if enc_dtype == "fp32":
        for k, g in zip(params, grads):
            w = np.asarray(jgrads[k])
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)


def test_l0_coeff_warmup_in_trainer():
    """The step's L0 coefficient ramps with the sparsity warmup: step 0
    adds no L0 term, and a penalized run ends with a lower L0 than an
    unpenalized one over the same steps."""
    def run(l0_coeff):
        cfg = CrossCoderConfig(d_in=16, dict_size=128, n_models=2, batch_size=64,
                               activation="jumprelu", jumprelu_theta=0.01,
                               jumprelu_bandwidth=0.05, l1_coeff=0.0, l0_coeff=l0_coeff,
                               enc_dtype="fp32", num_tokens=64 * 400, lr=1e-2,
                               l1_warmup_frac=0.1, log_backend="null")
        tr = trainer.Trainer(cfg, device="cpu")
        m0 = tr.step()
        assert float(m0["loss"]) == float(m0["l2_loss"])
        for _ in range(150):
            tr.step(full_metrics=False)
        m = tr.step()
        assert np.isfinite(float(m["loss"]))
        return float(m["l0_loss"])

    assert run(5e-2) < run(0.0)


def test_step_passes_the_warmed_l0_coeff(monkeypatch):
    cfg = CrossCoderConfig(d_in=8, dict_size=32, batch_size=8, activation="jumprelu",
                           l0_coeff=0.3, num_tokens=8 * 40, l1_warmup_frac=0.5,
                           log_backend="null")
    seen = []
    real = cc.training_loss

    def spy(*a, **kw):
        seen.append(kw.get("l0_coeff"))
        return real(*a, **kw)

    monkeypatch.setattr(cc, "training_loss", spy)
    tr = trainer.Trainer(cfg, device="cpu")
    for _ in range(3):
        tr.step()
    warm = trainer.schedules.sparsity_warmup_schedule(cfg)
    assert seen == [float(np.float32(0.3) * warm(s)) for s in range(3)]


STEPS = 16
TRAJ = dict(d_in=64, n_models=2, dict_size=512, batch_size=32, num_tokens=32 * STEPS,
            enc_dtype="fp32", log_backend="null", prefetch=False, seed=7, lr=5e-3,
            dec_init_norm=0.5, activation="jumprelu", jumprelu_theta=0.05,
            jumprelu_bandwidth=BW, l0_coeff=0.5, l1_coeff=0.5, l1_warmup_frac=0.0)


def _jax_trainer(kw, perturb=None, **tkw):
    cfg = JCfg(**kw)
    tr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                          **tkw)
    if perturb is not None:
        p = dict(tr.state.params)
        p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + perturb))
        tr.state = jax.device_put(tr.state._replace(params=p), tr._state_shardings)
    return tr


def test_trajectory_matches_jax_trainer_within_lyapunov_control():
    jtr = _jax_trainer(TRAJ)
    state = convert.train_state_from_numpy(jax.device_get(jtr.state), device="cpu")
    assert state.params["log_theta"].dtype == torch.float32
    cfg = CrossCoderConfig(**TRAJ)
    tr = trainer.Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", state=state)
    noise = np.random.default_rng(11).standard_normal((2, 64, 512)).astype(np.float32) * 1e-6
    ctl = _jax_trainer(TRAJ, perturb=noise)
    want = np.array([float(jtr.step()["loss"]) for _ in range(STEPS)])
    got = np.array([float(tr.step()["loss"]) for _ in range(STEPS)])
    control = np.array([float(ctl.step()["loss"]) for _ in range(STEPS)])
    lt_j = np.asarray(jax.device_get(jtr.state.params["log_theta"]))
    jtr.close()
    ctl.close()
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)
    # θ moved, and moved as JAX's did
    lt = tr.state.params["log_theta"].numpy()
    assert not np.allclose(lt, np.log(np.float32(0.05)))
    np.testing.assert_allclose(lt, lt_j, rtol=1e-3, atol=1e-4)


def _jleaves(state):
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


def _tleaves(state):
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in ckpt.flatten_state(state).items()}


@pytest.mark.parametrize("master_dtype", ["fp32", "bf16"])
def test_port_save_restores_in_jax_and_jax_save_in_port(tmp_path, master_dtype):
    kw = {**TRAJ, "master_dtype": master_dtype, "checkpoint_dir": str(tmp_path / "t")}
    cfg = CrossCoderConfig(**kw)
    tr = trainer.Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                         checkpointer=Checkpointer(cfg=cfg))
    for _ in range(3):
        tr.step()
    tr.save()
    spec = ckpt.state_spec(cfg)
    assert spec[".params['log_theta']"] == ((512,), torch.float32)
    assert spec[".opt_state[1].nu['log_theta']"] == ((512,), torch.float32)
    jtr = _jax_trainer(kw, checkpointer=JCheckpointer(base_dir=tmp_path / "t"))
    meta = jtr.restore()
    assert meta["step"] == 3
    got = _jleaves(jtr.state)
    want = _tleaves(tr.state)
    assert got[".params['log_theta']"].dtype == np.float32
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]).astype(np.float64),
                                      want[k].astype(np.float64), err_msg=k)
    params, _ = JCheckpointer.load_weights(JCheckpointer.latest_version_dir(tmp_path / "t"))
    np.testing.assert_array_equal(np.asarray(params["log_theta"]),
                                  tr.state.params["log_theta"].numpy())
    # and back: a JAX save read by the port
    jkw = {**kw, "checkpoint_dir": str(tmp_path / "j")}
    jtr2 = _jax_trainer(jkw, checkpointer=JCheckpointer(cfg=JCfg(**jkw)))
    for _ in range(2):
        jtr2.step()
    jtr2.save()
    tr2 = trainer.Trainer(CrossCoderConfig(**jkw), SyntheticActivationSource(cfg), device="cpu",
                          checkpointer=Checkpointer(base_dir=tmp_path / "j"))
    assert tr2.restore()["step"] == 2
    want = _jleaves(jtr2.state)
    got = _tleaves(tr2.state)
    assert tr2.state.params["log_theta"].dtype == torch.float32
    for k in got:
        np.testing.assert_array_equal(got[k].astype(np.float64),
                                      np.asarray(want[k]).astype(np.float64), err_msg=k)
    jtr.close()
    jtr2.close()


SHAPES = {"W_enc": (2, 8, 48), "W_dec": (48, 2, 8), "b_enc": (48,), "b_dec": (2, 8),
          "log_theta": (48,)}


@pytest.mark.parametrize("master", ["f32", "bf16"])
@pytest.mark.parametrize("norms", [(0.5, 0.25, 0.75), (0.5, 3.0, 0.8)],
                         ids=["below_clip", "both_sides"])
def test_plain_update_with_f32_log_theta_matches_optax(master, norms):
    """The update over bf16 (or f32) masters with an f32 ``log_theta``
    beside them, three steps, against the JAX package's optax chain on the
    same mixed tree. The global norm covers every leaf, ``log_theta``
    included. Bars: tests/test_torch_optimizer.py's for the masters; the
    f32 leaf 1e-6 relative under f32 masters; under bf16 masters the f32
    leaf sees the clip scale of a norm that optax sums per leaf in bf16,
    the port in f32, so it is held to 2^-7 relative."""
    tdt, jdt = DT[master]
    rng = np.random.default_rng(5)
    p0 = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for n in norms:
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        tot = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        grads.append({k: v * np.float32(n / tot) for k, v in g.items()})

    def dt(k, lib):
        return (torch.float32 if lib == "t" else jnp.float32) if k == "log_theta" else (
            tdt if lib == "t" else jdt)

    lr = 3e-3
    opt = Optimizer(CrossCoderConfig(d_in=8, dict_size=48, grad_clip=1.0), lambda c: lr)
    params = {k: torch.from_numpy(v.copy()).to(dt(k, "t")) for k, v in p0.items()}
    st = opt.init(params)
    for g in grads:
        params, st = opt.update({k: torch.from_numpy(v.copy()).to(dt(k, "t"))
                                 for k, v in g.items()}, st, params)
    tx = jstate.make_optimizer(JCfg(d_in=8, dict_size=48, grad_clip=1.0), lambda c: lr)
    jp = {k: jnp.asarray(v, dt(k, "j")) for k, v in p0.items()}
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v, dt(k, "j")) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
    assert params["log_theta"].dtype == st.mu["log_theta"].dtype == torch.float32
    for got, want, scale in ((params, jp, 3 * lr), (st.mu, js[1].mu, None),
                             (st.nu, js[1].nu, None)):
        for k in SHAPES:
            g = got[k].float().numpy()
            w = np.asarray(want[k], np.float32)
            if master == "f32" or (k == "log_theta" and norms[1] < 1):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=k)
            elif k == "log_theta":
                s = scale if scale is not None else np.abs(w).max()
                np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=2.0 ** -7 * s, err_msg=k)
            else:
                s = scale if scale is not None else np.abs(w).max()
                np.testing.assert_allclose(g, w, rtol=3 * 2.0 ** -7, atol=3 * 2.0 ** -7 * s,
                                           err_msg=k)


def test_adam_update_plain_takes_mixed_leaves_leaf_by_leaf():
    """Mixed leaves in one call equal each leaf updated alone: the plain
    version, which O1 is held to bitwise on the card, rounds each leaf in
    its own dtype."""
    gen = torch.Generator().manual_seed(3)
    leaves = {"W": torch.randn(64, generator=gen).to(torch.bfloat16),
              "log_theta": torch.randn(16, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in leaves.items()}
    mu = {k: torch.randn(v.shape, generator=gen).to(v.dtype) * 0.1 for k, v in leaves.items()}
    nu = {k: torch.rand(v.shape, generator=gen).to(v.dtype) * 0.1 for k, v in leaves.items()}
    norm = Optimizer.global_norm(grads)
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002, step_size=-1e-3)
    outs = tuple({k: torch.empty_like(v) for k, v in leaves.items()} for _ in range(3))
    adam.adam_update(leaves, grads, mu, nu, norm, out=outs, **kw)
    assert adam.adam_update.launches == 0
    for k in leaves:
        one = tuple({k: torch.empty_like(leaves[k])} for _ in range(3))
        adam.adam_update_plain({k: leaves[k]}, {k: grads[k]}, {k: mu[k]}, {k: nu[k]}, norm,
                               out=one, **kw)
        for a, b in zip(outs, one):
            assert a[k].dtype == leaves[k].dtype
            assert torch.equal(a[k], b[k]), k

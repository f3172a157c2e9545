"""The port's training loss and its gradients against the JAX package's
``jax.value_and_grad(crosscoder.training_loss)``, from the same params
(carried over by ``convert``) on the same numpy batch, for every tier the
port resolves: relu with l1 > 0, dense topk, factored, the sparse bare
step, the sparse AuxK step with a dead mask, and the fused step.

The JAX side runs its kernels in interpret mode (topk_pallas, sparse_grad,
fused_encoder_topk) and ranks AuxK latents exactly (``aux_exact_rank``),
as the port does. Bars, at f32 compute: loss relative 1e-5 and gradients
``atol 2e-5·max|g|`` (AuxK 2e-4), the JAX package's own bars for its
sparse-vs-dense gradient parity (tests/test_sparse_grad.py). The bf16 case
(relu, no selection to flip) holds loss to relative 2e-3 and gradients to
``atol 2e-2·max|g|``: both sides round pre-activations and the
reconstruction to bf16 after f32 sums taken in different orders."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc


@pytest.fixture(autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


BASE = dict(d_in=64, n_models=2, dict_size=512, topk_k=8, batch_size=32, enc_dtype="fp32",
            aux_exact_rank=True)
TIERS = {
    "relu_l1": dict(activation="relu", l1_coeff=2.0),
    "topk_dense": dict(activation="topk", l1_coeff=0.0, factored_decode="off",
                       sparse_bwd="off", fused_encoder="off"),
    "topk_factored": dict(activation="topk", l1_coeff=0.0, factored_decode="on",
                          sparse_bwd="off", fused_encoder="off"),
    "topk_sparse": dict(activation="topk", l1_coeff=0.0, sparse_bwd="on", fused_encoder="off",
                        dict_size=1920),
    "topk_sparse_auxk": dict(activation="topk", l1_coeff=0.0, sparse_bwd="on",
                             fused_encoder="off", aux_k=16),
    "topk_fused": dict(activation="topk", l1_coeff=0.0, sparse_bwd="on", fused_encoder="on"),
}


def _setup(kw, seed=0):
    jcfg = JCfg(**{**BASE, **kw})
    cfg = CrossCoderConfig(**{**BASE, **kw})
    jparams = jcc.init_params(jax.random.key(seed), jcfg, dtype=jnp.float32)
    params = convert.crosscoder_params_from_numpy(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((cfg.batch_size, cfg.n_sources, cfg.d_in)).astype(np.float32)
    x[1] = x[0]                                   # duplicate rows: duplicate latents
    return jcfg, cfg, jparams, params, x


def _jax_loss_grads(jcfg, jparams, x, l1, dead, aux_coeff, with_metrics=True):
    kw = {}
    if dead is not None:
        kw = dict(dead_mask=jnp.asarray(dead), aux_coeff=aux_coeff)

    def f(p):
        loss, losses = jcc.training_loss(p, jnp.asarray(x), l1, jcfg, with_metrics,
                                         track_fired=True, **kw)
        return loss, losses

    (loss, losses), grads = jax.value_and_grad(f, has_aux=True)(jparams)
    return float(loss), losses, {k: np.asarray(v) for k, v in grads.items()}


def _port_loss_grads(cfg, params, x, l1, dead, aux_coeff, with_metrics=True):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    kw = {}
    if dead is not None:
        kw = dict(dead_mask=torch.from_numpy(dead), aux_coeff=aux_coeff)
    loss, losses = cc.training_loss(p, torch.from_numpy(x), l1, cfg, with_metrics,
                                    track_fired=True, **kw)
    names = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names])
    losses = type(losses)(*(v.detach() if torch.is_tensor(v) else v for v in losses))
    return float(loss.detach()), losses, {k: g.numpy() for k, g in zip(names, grads)}


def _assert_close(port, jax_, rel, gtol):
    lp, lsp, gp = port
    lj, lsj, gj = jax_
    assert lp == pytest.approx(lj, rel=rel)
    for name in gj:
        scale = max(float(np.abs(gj[name]).max()), 1e-12)
        np.testing.assert_allclose(gp[name], gj[name], atol=gtol * scale, rtol=0,
                                   err_msg=f"gradient of {name}")
    assert float(lsp.l0_loss) == pytest.approx(float(lsj.l0_loss), rel=1e-6)
    np.testing.assert_allclose(lsp.explained_variance.numpy(),
                               np.asarray(lsj.explained_variance), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(lsp.fired.numpy(), np.asarray(lsj.fired))


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_training_loss_and_grads_match_jax(tier):
    kw = TIERS[tier]
    jcfg, cfg, jparams, params, x = _setup(kw)
    dead, aux_coeff, gtol = None, None, 2e-5
    if cfg.aux_k:
        dead = np.random.default_rng(9).random(cfg.dict_size) < 0.5
        aux_coeff, gtol = 0.25, 2e-4
    l1 = float(cfg.l1_coeff) * 0.5
    want = _jax_loss_grads(jcfg, jparams, x, l1, dead, aux_coeff)
    got = _port_loss_grads(cfg, params, x, l1, dead, aux_coeff)
    _assert_close(got, want, 1e-5, gtol)
    if cfg.aux_k:
        assert float(got[1].aux_loss) == pytest.approx(float(want[1].aux_loss), rel=1e-5)


def test_tier_gates_resolve_as_jax():
    """Every tier gate as JAX's; the fused tier as JAX's without its opt-in
    (``CROSSCODER_FUSED_TOPK_PALLAS``): "auto" is the dense encode, "on"
    the fused kernel. Under the opt-in (interpret mode here) JAX's "auto"
    would take the fused kernel at the three Gemma-2-2B-width shapes."""
    for kw in [*TIERS.values(), dict(activation="topk", l1_coeff=0.0, dict_size=2 ** 17,
                                     d_in=2304, batch_size=4096, topk_k=32, aux_k=64),
               dict(activation="topk", l1_coeff=0.0, dict_size=2 ** 15, d_in=2304,
                    batch_size=4096, topk_k=32, aux_k=64, aux_every=2, sparse_bwd="on"),
               dict(activation="topk", l1_coeff=0.0, dict_size=2 ** 14, d_in=2304,
                    batch_size=4096, topk_k=32, sparse_bwd="on")]:
        jcfg, cfg = JCfg(**{**BASE, **kw}), CrossCoderConfig(**{**BASE, **kw})
        B = cfg.batch_size
        assert cc.use_factored_decode(cfg) == jcc.use_factored_decode(jcfg)
        assert cc.use_sparse_bwd(cfg, B) == jcc.use_sparse_bwd(jcfg, B)
        assert cc.use_sparse_aux(cfg, B) == jcc.use_sparse_aux(jcfg, B)
        opted_in = jcc.use_fused_encoder(jcfg, B)
        jfek.set_interpret(False)
        try:
            assert cc.use_fused_encoder(cfg, B) == jcc.use_fused_encoder(jcfg, B)
        finally:
            jfek.set_interpret(True)
        if kw.get("dict_size", 0) >= 2 ** 14 and "fused_encoder" not in kw:
            assert opted_in and not cc.use_fused_encoder(cfg, B)


def test_bare_metrics_free_loss_matches_jax():
    """with_metrics=False (the bare variant) on the sparse tier: same loss
    and gradients, zeros in the metric slots."""
    jcfg, cfg, jparams, params, x = _setup(TIERS["topk_sparse"], seed=3)
    want = _jax_loss_grads(jcfg, jparams, x, 0.0, None, None, with_metrics=False)
    got = _port_loss_grads(cfg, params, x, 0.0, None, None, with_metrics=False)
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert float(got[1].l0_loss) == 0.0 and float(got[1].l1_loss) == 0.0
    with pytest.raises(ValueError, match="silently dropped"):
        cc.training_loss(params, torch.from_numpy(x), 0.5, cfg, with_metrics=False)


def test_bf16_relu_step_within_stated_tolerance():
    jcfg, cfg, jparams, params, x = _setup(dict(activation="relu", l1_coeff=2.0,
                                                enc_dtype="bf16"), seed=5)
    want = _jax_loss_grads(jcfg, jparams, x, 1.0, None, None)
    got = _port_loss_grads(cfg, params, x, 1.0, None, None)
    lp, _, gp = got
    lj, _, gj = want
    assert lp == pytest.approx(lj, rel=2e-3)
    for name in gj:
        scale = float(np.abs(gj[name]).max())
        np.testing.assert_allclose(gp[name], gj[name], atol=2e-2 * scale, rtol=0)


def test_fold_scaling_factors_matches_jax():
    _, _, jparams, params, _ = _setup(TIERS["relu_l1"])
    s = np.array([0.5, 2.0], np.float32)
    want = jax.device_get(jcc.fold_scaling_factors(jparams, s))
    got = cc.fold_scaling_factors(params, s)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)

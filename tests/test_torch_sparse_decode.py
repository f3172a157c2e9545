"""The port's ``sparse_decode`` path (crosscoder_tpu_torch/models/crosscoder.py
``topk_vals_idx``, ``_SparseDecodeProduct``, ``sparse_topk_forward``)
against the JAX package's (``lax.top_k`` selection, the gather decode and
its dense-scatter backward) and against the port's own dense TopK path.

Bars: losses and gradients 1e-5 relative in f32 against JAX (the decode
sums the k rows in ascending index order, JAX in descending value order),
plus 1e-6 of a gradient leaf's largest entry; against the dense path the
JAX package's own bars (tests/test_sparse_decode.py). The selected set
(the ``idx`` of the positive entries of ``vals``) equals JAX's exactly,
the values at 1e-6 relative. A
row with fewer than k positives pads its slots with the drain's ``(0,
0)``: the trap case gives every row a positive column 0, which an
unmasked gather would add to the reconstruction a second time."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import topk_pallas as tp
from crosscoder_tpu_torch.train import trainer

BASE = dict(d_in=24, dict_size=128, batch_size=64, enc_dtype="fp32", activation="topk",
            topk_k=8, l1_coeff=0.5, log_backend="null")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jtp.set_interpret(True)
    yield
    jtp.set_interpret(False)


def _case(seed, sparse_trap=False, **kw):
    kw = {**BASE, **kw}
    rng = np.random.default_rng(seed)
    jp = jax.device_get(jcc.init_params(jax.random.key(seed), JCfg(**kw), dtype=jnp.float32))
    x = rng.normal(size=(kw["batch_size"], 2, kw["d_in"])).astype(np.float32)
    if sparse_trap:
        # three positive latents a row at most (k = 8), column 0 among them
        b = np.full(kw["dict_size"], -50.0, np.float32)
        b[[0, 5, 77]] = 50.0
        jp["b_enc"] = b
    return kw, jp, x


def _torch_params(jp):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}


def _port(kw, jp, x, l1=0.5):
    params = _torch_params(jp)
    loss, losses = cc.training_loss(params, torch.from_numpy(x), l1, CrossCoderConfig(**kw))
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), losses, dict(zip(params, grads))


def _jax(kw, jp, x, l1=0.5):
    (loss, losses), grads = jax.value_and_grad(
        lambda p: jcc.training_loss(p, jnp.asarray(x), l1, JCfg(**kw)), has_aux=True)(
        {k: jnp.asarray(v) for k, v in jp.items()})
    return float(loss), losses, jax.device_get(grads)


def _close(got, want, rtol):
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=k)


@pytest.mark.parametrize("trap", [False, True], ids=["full_rows", "padded_rows"])
@pytest.mark.parametrize("l1", [0.5, 0.0])
def test_losses_and_gradients_match_jax_sparse_decode(trap, l1):
    kw, jp, x = _case(0, trap, sparse_decode=True, l1_coeff=l1)
    loss, losses, grads = _port(kw, jp, x, l1)
    jloss, jlosses, jgrads = _jax(kw, jp, x, l1)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for name in ("l2_loss", "l1_loss", "l0_loss"):
        np.testing.assert_allclose(float(getattr(losses, name).detach()),
                                   float(getattr(jlosses, name)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(losses.explained_variance.detach().numpy(),
                               np.asarray(jlosses.explained_variance), rtol=1e-4, atol=1e-6)
    _close(grads, jgrads, 1e-5)
    if trap:
        assert float(losses.l0_loss) <= 3


@pytest.mark.parametrize("trap", [False, True], ids=["full_rows", "padded_rows"])
def test_sparse_decode_matches_the_ports_dense_path(trap):
    kw, jp, x = _case(3, trap, sparse_decode=True)
    loss, losses, grads = _port(kw, jp, x)
    dloss, dlosses, dgrads = _port({**kw, "sparse_decode": False}, jp, x)
    np.testing.assert_allclose(loss, dloss, rtol=1e-5)
    np.testing.assert_allclose(float(losses.l1_loss.detach()), float(dlosses.l1_loss.detach()),
                               rtol=1e-5)
    assert float(losses.l0_loss) == float(dlosses.l0_loss)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), dgrads[k].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("trap", [False, True], ids=["full_rows", "padded_rows"])
def test_vals_idx_are_jax_selection_as_sets(trap):
    kw, jp, x = _case(5, trap, sparse_decode=True)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    vals, idx = cc.topk_vals_idx(params, torch.from_numpy(x), CrossCoderConfig(**kw))
    jvals, jidx = jcc.topk_vals_idx({k: jnp.asarray(v) for k, v in jp.items()},
                                    jnp.asarray(x), JCfg(**kw))
    jvals, jidx = np.asarray(jvals), np.asarray(jidx)
    assert vals.shape == idx.shape == (64, 8) and idx.dtype == torch.int32
    for b in range(64):
        got = {int(i): float(v) for i, v in zip(idx[b], vals[b].detach()) if v > 0}
        want = {int(i): float(v) for i, v in zip(jidx[b], jvals[b]) if v > 0}
        assert set(got) == set(want), b
        # the pre-activations' products sum in another order: 1e-6 relative
        np.testing.assert_allclose([got[i] for i in sorted(got)],
                                   [want[i] for i in sorted(want)], rtol=1e-6)
        if trap:
            # padding slots hold value 0, whatever relu(h[b, 0]) is
            assert len(got) <= 3 and 0 in got
            assert float(vals[b].detach().sum()) == pytest.approx(sum(want.values()), rel=1e-6)


def test_sparse_decode_reconstruction_equals_dense_decode_on_padded_rows():
    """The padding-slot trap itself: the k-row decode equals the dense
    decode of the TopK activations (column 0 counted once)."""
    kw, jp, x = _case(7, True, sparse_decode=True)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    cfg = CrossCoderConfig(**kw)
    recon, vals, idx = cc.sparse_topk_forward(params, torch.from_numpy(x), cfg)
    f = tp.topk_plain(cc.pre_acts(params, torch.from_numpy(x)), cfg.topk_k)
    dense = cc.decode(params, f)
    np.testing.assert_allclose(recon.detach().numpy(), dense.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(aux_k=16, aux_dead_steps=1), dict(enc_dtype="bf16"),
                                dict(l1_coeff=0.0, master_dtype="bf16", enc_dtype="bf16")])
def test_trainer_steps_with_sparse_decode(kw):
    cfg = CrossCoderConfig(**{**BASE, "batch_size": 16, "num_tokens": 16 * 8,
                              "sparse_decode": True, **kw})
    assert not cc.use_factored_decode(cfg) and not cc.use_sparse_bwd(cfg)
    tr = trainer.Trainer(cfg, device="cpu")
    ms = [tr.step() for _ in range(4)]
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    assert all(float(m["l0_loss"]) <= cfg.topk_k for m in ms)
    assert tp.topk.launches == tp.sparsify.launches == 0

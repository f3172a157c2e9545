"""The port's int8 gradient exchange (``parallel/quant_ar.py``) on 4 gloo
ranks against the JAX ``quantized_pmean_fn`` on a 4-device CPU mesh, from
the same numpy gradients and residuals: phase 1's ``q`` and scales are
the JAX compiled quantize's bytes, the mean and the residual agree within
1e-6 relative (the residual to the exchanged values' scale) round after
round, and the JAX package's own bars hold (the
mean within 2% of the exact one; the error-feedback running mean below a
quarter of the one-shot error). ``quant_grads`` on 4 data ranks tracks the
exact mesh run within 5e-3 over 20 steps (``tests/test_quant.py``'s bar).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from crosscoder_tpu.ops import quant as jquant
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.parallel import quant_ar as jqa
from crosscoder_tpu_torch.parallel import quant_ar

from _torch_parallel_child import run_ranks

N_DEV, BLOCK, ROUNDS = 4, 32, 3
SHAPES = {"odd": (7, 33), "flat": (256,), "wide": (3, 5, 40)}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in SHAPES.items():
        L = quant_ar.padded_len(int(np.prod(shape)), N_DEV, BLOCK)
        out[f"{name}/g"] = rng.normal(size=(ROUNDS, N_DEV, *shape)).astype(np.float32)
        out[f"{name}/ef"] = (rng.normal(size=(N_DEV, L)) * 0.01).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qar")
    inputs = _inputs(5)
    np.savez(tmp / "inputs.npz", **inputs)
    ranks = run_ranks(N_DEV, {"kind": "quant", "inputs": str(tmp / "inputs.npz"),
                              "rounds": ROUNDS, "block": BLOCK}, tmp / "out")
    return inputs, ranks


def test_padded_len_and_ef_init_match_jax():
    import torch

    for size in (1, 31, 32, 231, 1 << 12):
        for n in (1, 2, 4):
            assert quant_ar.padded_len(size, n, BLOCK) == jqa.padded_len(size, n, BLOCK)
    params = {"a": torch.zeros(7, 33), "b": torch.zeros(5)}
    got = quant_ar.ef_init(params, N_DEV, BLOCK)
    want = jqa.ef_init({"a": jnp.zeros((7, 33)), "b": jnp.zeros((5,))}, N_DEV, BLOCK)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_exchange_matches_jax_round_by_round(leaf, exchange):
    inputs, ranks = exchange
    fn = jqa.quantized_pmean_fn(jmesh.make_mesh(N_DEV, 1, devices=jax.devices()[:N_DEV]), BLOCK)
    quantize = jax.jit(jquant.quantize_blocks, static_argnums=1)
    g, ef = inputs[f"{leaf}/g"], jnp.asarray(inputs[f"{leaf}/ef"])
    L = ef.shape[-1]
    for r in range(ROUNDS):
        # phase 1's operands, as each rank formed them from its residual
        flat = np.zeros((N_DEV, L), np.float32)
        flat[:, : g[r, 0].size] = g[r].reshape(N_DEV, -1)
        own_ef = (np.asarray(ef) if r == 0 else
                  np.concatenate([ranks[d][leaf][r - 1]["ef"] for d in range(N_DEV)]))
        seg = jnp.asarray(flat + own_ef).reshape(N_DEV, N_DEV, L // N_DEV)
        out, ef = fn(jnp.asarray(g[r]), ef)
        out, ef_np = np.asarray(out), np.asarray(ef)
        for d in range(N_DEV):
            got = ranks[d][leaf][r]
            q, s = quantize(seg[d], BLOCK)
            np.testing.assert_array_equal(got["q"], np.asarray(q))
            np.testing.assert_array_equal(got["scales"], np.asarray(s))
            scale = np.abs(out[d]).max()
            np.testing.assert_allclose(got["out"], out[d], rtol=1e-6, atol=1e-6 * scale)
            # the residual seg - q·s: XLA-CPU contracts it into one fused
            # multiply-add, the port rounds q·s first, so they part at the
            # rounding of the exchanged values (ROADMAP C7's kind)
            np.testing.assert_allclose(got["ef"][0], ef_np[d], rtol=1e-6,
                                       atol=1e-6 * float(jnp.abs(seg[d]).max()))
            np.testing.assert_array_equal(got["out"], ranks[0][leaf][r]["out"])


def test_exchange_is_within_two_percent_of_the_exact_mean(exchange):
    inputs, ranks = exchange
    g = inputs["odd/g"][0]
    exact = g.mean(axis=0)
    # round 0 starts from the inputs' small residuals: compare to their mean too
    L = inputs["odd/ef"].shape[-1]
    ef = inputs["odd/ef"].reshape(N_DEV, L).sum(axis=0)[: exact.size].reshape(exact.shape)
    want = exact + ef / N_DEV
    got = ranks[0]["odd"][0]["out"]
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02


def test_error_feedback_unbiases_the_running_mean(tmp_path):
    rng = np.random.default_rng(6)
    steps = 16
    g = rng.normal(size=(N_DEV, 256)).astype(np.float32)
    L = quant_ar.padded_len(256, N_DEV, BLOCK)
    np.savez(tmp_path / "inputs.npz", **{"ef/g": np.broadcast_to(g, (steps, N_DEV, 256)),
                                         "ef/ef": np.zeros((N_DEV, L), np.float32)})
    ranks = run_ranks(N_DEV, {"kind": "quant", "inputs": str(tmp_path / "inputs.npz"),
                              "rounds": steps, "block": BLOCK}, tmp_path / "out")
    exact = g.mean(axis=0)
    outs = [r["out"] for r in ranks[0]["ef"]]
    one_shot = np.abs(outs[0] - exact).max()
    running = np.abs(np.mean(outs, axis=0) - exact).max()
    assert one_shot > 0
    assert running < one_shot / 4, (running, one_shot)


def test_quant_grads_trainer_tracks_the_exact_trajectory(tmp_path):
    base = dict(d_in=32, dict_size=64, batch_size=64, num_tokens=64 * 40, enc_dtype="fp32",
                lr=1e-3, l1_coeff=0.1, log_backend="null", quant_block=32, prefetch=False)
    ranks = run_ranks(N_DEV, {"kind": "train", "base": base, "data": N_DEV, "model": 1,
                              "steps": 20, "configs": {"quant": {"quant_grads": True},
                                                       "exact": {"quant_grads": False}}},
                      tmp_path)
    lq = np.array([s["loss"] for s in ranks[0]["quant"]["steps"]])
    lb = np.array([s["loss"] for s in ranks[0]["exact"]["steps"]])
    assert np.isfinite(lq).all()
    rel = np.abs(lq - lb) / np.maximum(np.abs(lb), 1e-9)
    assert rel.max() < 5e-3, rel.max()
    assert rel.max() > 0            # the exchange did quantize
    for r in ranks[1:]:
        assert [s["loss"] for s in r["quant"]["steps"]] == list(lq)

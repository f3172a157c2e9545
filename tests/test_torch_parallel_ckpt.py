"""Checkpoints across gloo ranks: a save on a 2×2 grid (the shards
gathered, the primary writing) restores bitwise on the grid, on one rank
and in the JAX ``Checkpointer``; the ranks agree on the save when one
rank's newest is missing; the ``quant_grads`` residuals survive a restore
on the same ``data`` width and reset to zero on another (the JAX
restore-with-respec); a SIGTERM that reaches one rank stops every rank
at the same step, whose save they make together; the loss guard's
rollback on a grid agrees on the save the primary last wrote, however long
that write takes to land."""

import shutil

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.train.trainer import Trainer

from _torch_parallel_child import run_ranks

BASE = dict(d_in=16, n_models=2, dict_size=64, batch_size=16, num_tokens=16 * 8,
            enc_dtype="fp32", log_backend="null", prefetch=False, seed=3, lr=5e-3)
TOPK = dict(activation="topk", topk_k=4, l1_coeff=0.0, sparse_bwd="on", aux_k=8,
            aux_dead_steps=1, aux_every=2, aux_mask_every=2)
QUANT = dict(activation="relu", l1_coeff=0.1, quant_grads=True, quant_block=16)


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _task(root, configs, d, m, **kw):
    return {"kind": "ckpt", "base": BASE, "configs": configs, "data": d, "model": m,
            "root": str(root), **kw}


@pytest.fixture(scope="module")
def grid_save(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    root = tmp / "ckpt"
    ranks = run_ranks(4, _task(root, {"topk": TOPK}, 2, 2, steps=4, save_at=[2],
                               views=[str(root)]), tmp / "out")
    return root, ranks


def _one_rank(root, kw):
    cfg = CrossCoderConfig(**{**BASE, **kw})
    tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu",
                 checkpointer=Checkpointer(root))
    meta = tr.restore()
    return tr, meta


def test_only_the_primary_writes_one_version_dir(grid_save):
    root, ranks = grid_save
    assert [p.name for p in root.iterdir()] == ["version_0"]
    assert Checkpointer.complete_saves(root / "version_0") == [0, 1]
    assert ranks[0]["save_dir"] is not None
    assert all(r["save_dir"] is None for r in ranks[1:])


def test_grid_save_restores_bitwise_on_the_grid(grid_save):
    _, ranks = grid_save
    for r in ranks:
        got = r["restored"][0]
        assert got["step"] == 4
        for k, v in ranks[0]["saved"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


def test_grid_save_restores_bitwise_on_one_rank(grid_save):
    root, ranks = grid_save
    tr, meta = _one_rank(root, TOPK)
    assert meta["step"] == 4 and tr.step_counter == 4
    for k, v in ranks[0]["saved"].items():
        np.testing.assert_array_equal(tr.state.params[k].numpy(), v, err_msg=k)
    assert tr.state.aux["dead_mask"].shape == (64,)
    np.testing.assert_array_equal(tr.state.aux["steps_since_fired"].numpy(),
                                  ranks[0]["restored"][0]["aux"]["steps_since_fired"])
    assert np.isfinite(float(tr.step()["loss"]))


def test_grid_save_restores_in_the_jax_checkpointer(grid_save):
    root, ranks = grid_save
    cfg = JCfg(**{**BASE, **TOPK})
    jtr = jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                           checkpointer=JCheckpointer(base_dir=root))
    meta = jtr.restore()
    assert meta["step"] == 4
    for k, v in ranks[0]["saved"].items():
        np.testing.assert_array_equal(np.asarray(jtr.state.params[k]), v, err_msg=k)


def test_ranks_agree_when_one_ranks_newest_save_is_missing(grid_save, tmp_path):
    root, _ = grid_save
    views = []
    for r in range(4):
        v = tmp_path / f"view{r}"
        shutil.copytree(root, v)
        views.append(str(v))
    (tmp_path / "view2" / "version_0" / "1_meta.json").unlink()
    ranks = run_ranks(4, _task(tmp_path / "unused", {"topk": TOPK}, 2, 2, views=[views]),
                      tmp_path / "out")
    tr, meta = _one_rank(root, TOPK)
    tr.restore(version_dir=root / "version_0", save=0)
    for r in ranks:
        got = r["restored"][0]
        assert got["save_version"] == 0 and got["step"] == 2
        for k, v in tr.state.params.items():
            np.testing.assert_array_equal(got["params"][k], v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def quant_save(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quant")
    root = tmp / "ckpt"
    ranks = run_ranks(4, _task(root, {"quant": QUANT}, 4, 1, steps=3, views=[str(root)]),
                      tmp / "out")
    return root, ranks


def test_quant_ef_survives_the_same_data_width(quant_save):
    root, ranks = quant_save
    saved = ranks[0]["saved_ef"]
    assert set(saved) == {"W_dec", "W_enc", "b_dec", "b_enc"}
    assert saved["W_enc"].shape[0] == 4 and np.abs(saved["W_enc"]).max() > 0
    for r in ranks:
        for p, v in saved.items():
            np.testing.assert_array_equal(r["restored"][0]["aux"]["quant_ef"][p], v)
    cfg = JCfg(**{**BASE, **QUANT, "data_axis_size": 4})
    jtr = jtrainer.Trainer(cfg, JSource(cfg),
                           mesh=jmesh.make_mesh(4, 1, devices=jax.devices()[:4]),
                           checkpointer=JCheckpointer(base_dir=root))
    jtr.restore()
    for p, v in saved.items():
        np.testing.assert_array_equal(np.asarray(jtr.state.aux["quant_ef"][p]), v, err_msg=p)


def test_quant_ef_resets_on_another_data_width(quant_save, tmp_path):
    root, ranks = quant_save
    two = run_ranks(2, _task(tmp_path / "unused", {"quant": QUANT}, 2, 1, views=[str(root)]),
                    tmp_path / "out")
    for r in two:
        got = r["restored"][0]
        for p, v in got["aux"]["quant_ef"].items():
            assert v.shape[0] == 2 and not v.any(), p
        for k, v in ranks[0]["saved"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
    tr, _ = _one_rank(root, {**QUANT, "quant_grads": True})
    assert tr.state.aux is None or "quant_ef" not in tr.state.aux
    for k, v in ranks[0]["saved"].items():
        np.testing.assert_array_equal(tr.state.params[k].numpy(), v, err_msg=k)
    assert torch.isfinite(tr.step()["loss"])


def test_a_sigterm_on_one_rank_stops_every_rank_at_one_step_and_saves(tmp_path):
    root = tmp_path / "ckpt"
    base = {**BASE, "stop_poll_every": 2, "save_every": 100}
    ranks = run_ranks(2, {"kind": "stop", "base": base, "configs": {"relu": {}}, "data": 2,
                          "root": str(root), "signal_at": 3}, tmp_path / "out")
    # rank 1 flags the stop in step 3's serve; the flag is read at step 4
    assert [r["step"] for r in ranks] == [4, 4]
    meta = Checkpointer.complete_saves(root / "version_0")
    assert meta == [0]
    tr, m = _one_rank(root, {"activation": "relu"})
    assert m["step"] == 4


def test_the_guard_rollback_waits_for_the_primarys_write_in_flight(tmp_path):
    """A NaN in serve 3 poisons save 2 (step 4), written in the background;
    the rollback at step 4 must see it, skip it as poisoned and restore
    save 1 on every rank, as the single-device run does. A rank that
    listed the saves before the primary's write landed agreed the ranks
    onto save 1 directly, with no poisoned-save skip counted."""
    from _torch_mesh_rest_child import PoisonedSource

    guard = dict(activation="relu", l1_coeff=0.1, guard_loss=True, log_every=2, save_every=2,
                 max_rollbacks=2)
    base = {**BASE, "num_tokens": 16 * 8}
    ranks = run_ranks(2, {"kind": "guard", "base": base, "configs": {"guard": guard},
                          "data": 1, "model": 2, "root": str(tmp_path / "grid"),
                          "nan_serves": [3], "slow_write_s": 0.5}, tmp_path / "out")
    cfg = CrossCoderConfig(**base, **guard, checkpoint_dir=str(tmp_path / "one"))
    tr = Trainer(cfg, PoisonedSource(SyntheticActivationSource(cfg), [3]), device="cpu",
                 checkpointer=Checkpointer(cfg=cfg))
    tr.train()
    want = tr.resilience.snapshot()
    assert want["resilience/rollbacks"] == 1 and want["resilience/poisoned_save_skips"] == 1
    for r in ranks:
        assert r["resilience"] == want
        assert r["step"] == tr.step_counter == 8

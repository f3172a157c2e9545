"""The port's rank grid and sharding rules against the JAX package's: the
spec of every train-state leaf equals the JAX ``state_shardings`` one,
``local_shard`` cuts what concatenation restores, ``make_mesh`` and the
config refuse what the JAX ones refuse, start-up joins no group unless
asked, and the mesh trainer builds every knob it used to refuse."""

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import schedules as jsched
from crosscoder_tpu.train import state as jstate
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.buffer import make_buffer
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.train import schedules
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
from crosscoder_tpu_torch.train.trainer import Trainer

from _torch_parallel_child import run_ranks

BASE = dict(d_in=8, dict_size=32, batch_size=8, num_tokens=16, log_backend="null",
            enc_dtype="fp32")
FULL = dict(activation="jumprelu", aux_k=4, aux_mask_every=2, quant_grads=True,
            quant_block=16, data_axis_size=2)


def _fake_mesh(d, m, dr=0, mr=0):
    return mesh_lib.Mesh(data_size=d, model_size=m, data_rank=dr, model_rank=mr,
                         data_group=None, model_group=None, world_group=None)


@pytest.mark.parametrize("name", ["W_enc", "W_dec", "b_enc", "b_dec", "log_theta",
                                  "steps_since_fired", "dead_mask"])
def test_param_spec_equals_jax(name):
    assert mesh_lib.param_spec(name) == tuple(jmesh.param_spec(name))


def test_unknown_param_has_no_rule():
    with pytest.raises(ValueError, match="no sharding rule"):
        mesh_lib.param_spec("W_other")


def test_state_specs_equal_jax_state_shardings():
    jcfg = JCfg(**BASE, **FULL)
    tx = jstate.make_optimizer(jcfg, jsched.lr_schedule(jcfg))
    jst = jstate.init_train_state(jax.random.key(0), jcfg, tx, n_data=2)
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(jmesh.state_shardings(jm, jst))[0]}
    cfg = CrossCoderConfig(**BASE, **FULL)
    st = init_train_state(cfg, Optimizer(cfg, schedules.lr_schedule(cfg)), device="cpu",
                          n_data=2)
    got = mesh_lib.state_specs(st)
    assert ".aux['quant_ef']['W_enc']" in got and ".opt_state[1].mu['log_theta']" in got
    for key, spec in got.items():
        assert spec == want[key], key


@pytest.mark.parametrize("d,m", [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)])
def test_local_shards_concatenate_back_to_the_state(d, m):
    cfg = CrossCoderConfig(**{**BASE, **FULL, "data_axis_size": d})
    st = init_train_state(cfg, Optimizer(cfg, schedules.lr_schedule(cfg)), device="cpu",
                          n_data=max(d, 2))
    shards = {(i, j): mesh_lib.shard_state(_fake_mesh(d, m, i, j), st)
              for i in range(d) for j in range(m)}
    for name, full in st.params.items():
        dim = mesh_lib.shard_dim(mesh_lib.param_spec(name))
        rows = [shards[(0, j)].params[name] for j in range(m)]
        got = torch.cat(rows, dim=dim[0]) if dim else rows[0]
        torch.testing.assert_close(got, full, rtol=0, atol=0)
        for i in range(d):        # replicated over data
            torch.testing.assert_close(shards[(i, 0)].params[name], rows[0], rtol=0, atol=0)
        assert shards[(0, 0)].params[name].is_contiguous()
    ef = st.aux["quant_ef"]["W_dec"]
    got = torch.cat([shards[(i, 0)].aux["quant_ef"]["W_dec"] for i in range(d)])
    np.testing.assert_array_equal(got.numpy(), ef[: got.shape[0]].numpy())
    sssf = torch.cat([shards[(0, j)].aux["steps_since_fired"] for j in range(m)])
    assert sssf.shape == st.aux["steps_since_fired"].shape


def test_local_shard_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        multihost.local_shard(torch.zeros(5), (0, 2, 0))


def test_make_mesh_refuses_as_jax_does():
    with pytest.raises(ValueError, match="must divide device count 1"):
        mesh_lib.make_mesh(-1, 2)
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        mesh_lib.make_mesh(2, 1)
    with pytest.raises(RuntimeError, match="needs a process group"):
        mesh_lib.make_mesh(-1, 1)


def test_initialize_joins_nothing_unless_asked(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary() and not multihost.needs_launch_tickets()
    info = multihost.process_info()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert multihost.local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw,match", [
    ({"quant_grads": True, "data_axis_size": 2, "model_axis_size": 2}, "pure data parallelism"),
    ({"quant_grads": True, "shard_sources": True}, "pure data parallelism"),
    ({"quant_grads": True, "activation": "batchtopk"}, "incompatible with activation"),
])
def test_config_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        CrossCoderConfig(**BASE, **kw)
    with pytest.raises(ValueError, match=match):
        JCfg(**BASE, **kw)


_TOPK = dict(activation="topk", topk_k=4, l1_coeff=0.0, dict_size=256)   # the TopK tiers' gate


@pytest.mark.parametrize("kw,grid,match", [
    ({**_TOPK, "sparse_bwd": "on", "fused_encoder": "on"}, (1, 2), "fused encoder tier"),
    ({**_TOPK, "sparse_bwd": "on", "fused_encoder": "on", "quant_encoder": True,
      "d_in": 64, "quant_block": 128}, (1, 2), "fused encoder tier"),
    ({"activation": "batchtopk", "topk_k": 4, "fused_encoder": "on"}, (2, 1),
     "fused BatchTopK"),
    ({**_TOPK, "sparse_decode": True}, (1, 2), "sparse_decode over a model axis"),
    ({"resample_every": 2}, (1, 1), "resampling"),
    ({"guard_loss": True}, (1, 1), "loss guard"),
], ids=["fused_topk_tp", "quant_encoder_tp", "fused_batchtopk_dp", "sparse_decode_tp",
        "resample", "guard_loss"])
def test_mesh_builds_what_it_used_to_refuse(kw, grid, match, tmp_path):
    """Each knob an earlier slice refused on a grid builds there (``match``
    names it; ``tests/test_torch_mesh_rest.py`` trains each on gloo ranks
    against JAX). On a grid of one, resampling and the guard run: the
    resample at its step, and a NaN loss the verdict every rank agrees on."""
    cfg = CrossCoderConfig(**{**BASE, **kw})
    tr = Trainer(cfg, device="cpu", mesh=_fake_mesh(*grid))
    assert tr.mesh.data_size * tr.mesh.model_size == grid[0] * grid[1], match
    if kw.get("resample_every"):
        steps = [tr.step() for _ in range(3)]
        assert "resampled" in steps[2] and "resampled" not in steps[1]
    if kw.get("guard_loss"):
        assert tr._loss_diverged(float("nan")) and not tr._loss_diverged(1.0)
        assert tr._params_finite()


def test_shard_sources_and_the_buffer_on_many_ranks_raise(monkeypatch):
    """shard_sources trains (one device holds every source); a host store on
    more than one rank is the JAX ValueError, raised before any harvest."""
    tr = Trainer(CrossCoderConfig(**BASE, shard_sources=True), device="cpu")
    assert torch.isfinite(tr.step()["loss"])
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="buffer_device='host' cannot run on a multi-process"):
        make_buffer(CrossCoderConfig(**BASE), None, [], None)


def test_mesh_shapes_must_split():
    with pytest.raises(ValueError, match="dict_size 32 must divide by model_axis_size 3"):
        Trainer(CrossCoderConfig(**BASE), device="cpu", mesh=_fake_mesh(1, 3))
    with pytest.raises(ValueError, match="batch_size 8 must divide by the data axis 3"):
        Trainer(CrossCoderConfig(**BASE), device="cpu", mesh=_fake_mesh(3, 1))


def test_collectives_sum_and_their_gradients_pass_as_documented(tmp_path):
    """On 3 gloo ranks: ``sum_over`` sums and passes the cotangent through
    once (a replicated downstream), ``copy_to`` sums the cotangents; the
    gathers and the all-to-all keep group-rank order; each call counted."""
    ranks = run_ranks(3, {"kind": "coll"}, tmp_path)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["sum"].numpy(), [6.0, 6.0, 6.0])
        np.testing.assert_array_equal(res["x_grad"].numpy(), [1.0, 2.0, 3.0])
        np.testing.assert_array_equal(res["p_grad"].numpy(), [6.0, 6.0, 6.0])
        np.testing.assert_array_equal(res["gather"].numpy(), [[0, 1, 2]])
        want = [[2 * r + 10 * s, 2 * r + 1 + 10 * s] for s in range(3)]
        np.testing.assert_array_equal(res["to_all"].numpy(), want)
        assert res["calls"] == {"all_reduce": 2, "all_gather": 1, "all_to_all": 1}

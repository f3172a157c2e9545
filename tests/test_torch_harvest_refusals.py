"""What the parallel harvest used to refuse and now takes, and the JAX
package's ``ValueError``s it ported.

Taken, where an earlier slice raised :class:`NotImplementedError`: the
refill overlap with a harvest or store that issues collectives (the mesh
store, ``shard_lm``, ``seq_shards``, tensor-parallel params: no dispatcher
thread, the credit pumped inline), the paged harvest under ``shard_lm``,
the fused tiers and ``sparse_decode`` under ``shard_sources`` on a model
axis wider than 1, and a tensor-parallel LM whose head counts the model
axis does not divide (``tests/test_torch_mesh_rest.py`` runs each on gloo
ranks against JAX). The ``ValueError``s follow the JAX buffer and config:
a host store on many ranks, ``seq_shards`` other than the data axis,
``shard_lm`` with a model axis below 2 or with ``seq_shards``, the paged
runtime with ``seq_shards``, ``n_sources`` not divisible under
``shard_sources``; and the port's own: a tensor-parallel LM whose widths
(``d_model``, ``d_ff``, the flat q and k/v widths) the model axis does not
divide."""

import dataclasses

import numpy as np
import pytest
import torch

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.train.trainer import Trainer

KW = dict(batch_size=32, buffer_mult=32, seq_len=17, d_in=32, n_models=2, model_batch_size=4,
          norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre")
TOKENS = np.ones((64, 17), np.int64)


def _fake_mesh(d, m):
    return mesh_lib.Mesh(data_size=d, model_size=m, data_rank=0, model_rank=0, data_group=None,
                         model_group=None, world_group=None)


def test_refill_overlap_on_a_mesh_store_pumps_inline():
    """The mesh store keeps the overlap's spare rows in its shards and
    starts no dispatcher thread (built lazy: no collective runs)."""
    cfg = CrossCoderConfig(**KW, buffer_device="hbm", refill_overlap="on")
    b = buf.MeshPairedActivationBuffer(cfg, None, [{}, {}], TOKENS, device="cpu",
                                       mesh=_fake_mesh(2, 1), lazy=True)
    assert b._dispatcher is None and b._spare_rows == b._refill_batches() * 16
    assert b._rows_local == -(-(b.buffer_size + b._spare_rows) // 2)


@pytest.mark.parametrize("kw,grid", [
    (dict(shard_lm=True, model_axis_size=2, buffer_device="hbm"), (1, 2)),
    (dict(seq_shards=2, data_axis_size=2, seq_len=16), (2, 1)),
], ids=["shard_lm", "seq_shards"])
def test_refill_overlap_with_a_collective_harvest_pumps_inline(kw, grid):
    """The overlap's dispatcher thread would run the harvest's collectives
    beside the trainer's, whatever store holds the rows: a 1 × 2 grid under
    ``shard_lm`` and a host store under ``seq_shards`` build the plain
    store, with the spare rows and no thread."""
    cfg = CrossCoderConfig(**{**KW, **kw}, refill_overlap="on")
    tokens = TOKENS[:, :cfg.seq_len]
    b = buf.make_buffer(cfg, None, [{}, {}], tokens, device="cpu", mesh=_fake_mesh(*grid),
                        lazy=True)
    assert type(b) is buf.PairedActivationBuffer
    assert b._dispatcher is None and b._spare_rows > 0
    plain = buf.make_buffer(cfg.replace(shard_lm=False, seq_shards=1, model_axis_size=1,
                                        data_axis_size=1), None, [{}, {}], tokens,
                            device="cpu", lazy=True)
    assert plain._dispatcher is not None                # one process, no collectives
    plain.close()


def test_refill_overlap_with_tensor_parallel_params_pumps_inline():
    """TP params handed to a buffer whose config does not say ``shard_lm``
    pump inline as well: their forward all-reduces over ``model``."""
    cfg = CrossCoderConfig(**KW, buffer_device="hbm", refill_overlap="on")
    params = {lm.TP_KEY: lm.TPGroup(None, 0)}
    b = buf.PairedActivationBuffer(cfg, None, [params, params], TOKENS, device="cpu", lazy=True)
    assert b._dispatcher is None and b._overlap


def test_paged_harvest_under_shard_lm_runs_the_paged_forward():
    """The config and the buffer take the paged runtime under ``shard_lm``,
    and the paged forward takes TP params: over a group of one it is
    bitwise the whole params' paged harvest."""
    cfg = CrossCoderConfig(**{**KW, "seq_len": 16}, buffer_device="hbm", shard_lm=True,
                           model_axis_size=2, harvest_runtime="paged", page_size=16)
    b = buf.make_buffer(cfg, None, [{}, {}], TOKENS[:, :16], device="cpu", mesh=_fake_mesh(1, 2),
                        lazy=True)
    assert b._paged
    params = lm.init_params(lm.LMConfig.tiny(), seed=0, device="cpu")
    tp = dict(params)
    tp[lm.TP_KEY] = lm.TPGroup(None, 0)
    tokens = np.random.default_rng(0).integers(1, 257, (2, 16))
    tokens[1, 9:] = 0
    args = (tokens, [16, 9], lm.LMConfig.tiny(), ["blocks.1.hook_resid_pre"])
    got = lm.run_with_cache_multi_paged([tp], *args, page_size=8)
    want = lm.run_with_cache_multi_paged([params], *args, page_size=8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(activation="topk", topk_k=4, l1_coeff=0.0, dict_size=256, sparse_bwd="on",
         fused_encoder="on"),
    dict(activation="topk", topk_k=4, l1_coeff=0.0, dict_size=256, sparse_decode=True),
], ids=["fused_topk", "sparse_decode"])
def test_shard_sources_takes_the_item5_knobs(kw):
    """A ``shard_sources`` Trainer on a 1 × 2 grid builds with the fused
    tier and ``sparse_decode``: each rank keeps one source slab of
    ``W_enc`` (gathered over ``model`` only inside the fused step)."""
    cfg = CrossCoderConfig(d_in=8, batch_size=8, num_tokens=16, log_backend="null",
                           shard_sources=True, **kw)
    tr = Trainer(cfg, device="cpu", mesh=_fake_mesh(1, 2))
    assert tuple(tr.state.params["W_enc"].shape) == (1, 8, 256)


def test_host_store_on_many_ranks_is_the_jax_value_error(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="buffer_device='host' cannot run on a multi-process"):
        buf.PairedActivationBuffer(CrossCoderConfig(**KW), None, [{}, {}], TOKENS,
                                   device="cpu")


def test_seq_shards_must_equal_the_data_axis():
    cfg = CrossCoderConfig(**{**KW, "seq_len": 16}, buffer_device="hbm", seq_shards=4)
    with pytest.raises(ValueError, match="seq_shards 4 != mesh data axis 2"):
        buf.MeshPairedActivationBuffer(cfg, None, [{}, {}], TOKENS[:, :16], device="cpu",
                                       mesh=_fake_mesh(2, 1))
    with pytest.raises(ValueError, match="seq_shards 4 != mesh data axis 1"):
        buf.make_buffer(cfg, None, [{}, {}], TOKENS[:, :16], device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(shard_lm=True), "shard_lm needs model_axis_size >= 2"),
    (dict(shard_lm=True, model_axis_size=2, seq_shards=2, seq_len=16),
     "shard_lm is incompatible with seq_shards"),
    (dict(harvest_runtime="paged", page_size=8, seq_shards=2, seq_len=16),
     "incompatible with seq_shards"),
    (dict(n_models=3, model_axis_size=2, shard_sources=True), "must divide by model_axis_size"),
], ids=["shard_lm_model1", "shard_lm_seq", "paged_seq", "sources_indivisible"])
def test_config_refuses_what_jax_refuses(kw, match):
    full = {**KW, **kw}
    with pytest.raises(ValueError, match=match):
        CrossCoderConfig(**full)
    with pytest.raises(ValueError, match=match):
        JCfg(**full)


@pytest.mark.parametrize("m", [3, 4])
def test_tp_takes_head_counts_the_axis_does_not_divide(m):
    """4 query heads on 2 KV heads split over 4 ranks (JAX's flat slices of
    the q and k/v widths); 3 ranks do not divide ``d_model`` 32, a
    :class:`ValueError` naming the width."""
    cfg = lm.LMConfig.tiny()            # 4 query heads, 2 KV heads
    params = lm.init_params(cfg, seed=0, device="cpu")
    if m == 3:
        with pytest.raises(ValueError, match="d_model 32 must divide by 3"):
            lm.check_tp(cfg, m)
        with pytest.raises(ValueError, match="d_model 32"):
            lm.shard_params_tp(params, _fake_mesh(1, m), cfg)
        return
    lm.check_tp(cfg, m)
    tp = lm.shard_params_tp(params, _fake_mesh(1, m), cfg)
    assert tp["layers"]["wq"].shape[-1] == 4 * 8 // m
    assert tp["layers"]["wk"].shape[-1] == 2 * 8 // m
    odd = dataclasses.replace(cfg, n_kv_heads=1, head_dim=6, d_model=24, d_ff=48)
    with pytest.raises(ValueError, match="the k/v width n_kv_heads·head_dim 6 must divide by 4"):
        lm.check_tp(odd, 4)


@pytest.mark.parametrize("name", ["gemma2_2b", "gemma2_9b", "gemma2_27b"])
def test_gemma2_head_counts_split_over_2_and_4(name):
    cfg = getattr(lm.LMConfig, name)()
    for m in (2, 4):
        lm.check_tp(cfg, m)


def test_tp_forward_refuses_a_graph_that_needs_gradients():
    cfg = lm.LMConfig.tiny()
    params = lm.init_params(cfg, seed=0, device="cpu")
    params["embed"].requires_grad_(True)
    params[lm.TP_KEY] = lm.TPGroup(None, 0)
    with pytest.raises(NotImplementedError, match="torch.no_grad"):
        lm.forward(params, torch.ones((1, 4), dtype=torch.long), cfg)


def test_shard_sources_specs_equal_jax():
    from crosscoder_tpu.parallel import mesh as jmesh

    for name in mesh_lib._SOURCE_SPECS:
        assert mesh_lib.param_spec(name, True) == tuple(jmesh.param_spec(name, True)), name


@pytest.mark.parametrize("n,chunk", [(2, 4), (3, 6), (4, 4)])
def test_mesh_store_geometry_is_the_jax_one(n, chunk):
    """The harvest chunk rounds up to the data axis, each rank holds
    ceil(rows / n) rows and the store pads to n of them (built lazy: no
    collective runs before the fill). A batch the axis does not split is
    refused."""
    cfg = CrossCoderConfig(**{**KW, "batch_size": 48}, buffer_device="hbm")
    b = buf.MeshPairedActivationBuffer(cfg, None, [{}, {}], TOKENS, device="cpu",
                                       mesh=_fake_mesh(n, 1), lazy=True)
    assert b._chunk_seqs == chunk
    assert b._rows_local == -(-b.buffer_size // n)
    assert n * b._rows_local >= b.buffer_size
    assert b._store_dev.shape == (b._rows_local, 2, 32)
    with pytest.raises(ValueError, match="batch_size 48 must divide by the mesh data axis 5"):
        buf.MeshPairedActivationBuffer(cfg, None, [{}, {}], TOKENS, device="cpu",
                                       mesh=_fake_mesh(5, 1), lazy=True)

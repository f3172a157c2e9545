"""What the parallel harvest still refuses, and the JAX package's
``ValueError``s it ported.

Refused with :class:`NotImplementedError` naming its ``ROADMAP.md`` item:
the refill overlap with a harvest or store that issues collectives (the
mesh store, ``shard_lm``, ``seq_shards``; A6b item 4a), the paged harvest under
``shard_lm`` (A6b item 4b), the fused tiers under ``shard_sources`` on a
model axis wider than 1 (A6b item 5). The ``ValueError``s follow the JAX
buffer and config: a host store on many ranks, ``seq_shards`` other than
the data axis, ``shard_lm`` with a model axis below 2 or with
``seq_shards``, the paged runtime with ``seq_shards``, ``n_sources`` not
divisible under ``shard_sources``; and the port's own: a tensor-parallel LM
whose head counts the model axis does not divide."""

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


def test_refill_overlap_on_a_mesh_store_names_its_roadmap_item():
    cfg = CrossCoderConfig(**KW, buffer_device="hbm", refill_overlap="on")
    with pytest.raises(NotImplementedError, match="ROADMAP A6b item 4a"):
        buf.MeshPairedActivationBuffer(cfg, None, [{}, {}], TOKENS, device="cpu",
                                       mesh=_fake_mesh(2, 1))


@pytest.mark.parametrize("kw,grid", [
    (dict(shard_lm=True, model_axis_size=2, buffer_device="hbm"), (1, 2)),
    (dict(seq_shards=2, data_axis_size=2, seq_len=16), (2, 1)),
], ids=["shard_lm", "seq_shards"])
def test_refill_overlap_with_a_collective_harvest_names_its_roadmap_item(kw, grid):
    """The overlap's dispatcher thread would run the harvest's collectives
    beside the trainer's, whatever store holds the rows: a 1 × 2 grid under
    ``shard_lm`` and a host store under ``seq_shards`` build the plain
    store, and are refused all the same."""
    cfg = CrossCoderConfig(**{**KW, **kw}, refill_overlap="on")
    tokens = TOKENS[:, :cfg.seq_len]
    b = buf.make_buffer(cfg.replace(refill_overlap="off"), None, [{}, {}], tokens,
                        device="cpu", mesh=_fake_mesh(*grid), lazy=True)
    assert type(b) is buf.PairedActivationBuffer
    with pytest.raises(NotImplementedError, match="ROADMAP A6b item 4a"):
        buf.make_buffer(cfg, None, [{}, {}], tokens, device="cpu", mesh=_fake_mesh(*grid))


def test_refill_overlap_with_tensor_parallel_params_names_its_roadmap_item():
    """TP params handed to a buffer whose config does not say ``shard_lm``
    are refused as well: their forward all-reduces over ``model``."""
    cfg = CrossCoderConfig(**KW, buffer_device="hbm", refill_overlap="on")
    params = {lm.TP_KEY: lm.TPGroup(None, 0)}
    with pytest.raises(NotImplementedError, match="ROADMAP A6b item 4a"):
        buf.PairedActivationBuffer(cfg, None, [params, params], TOKENS, device="cpu")


def test_paged_harvest_under_shard_lm_names_its_roadmap_item():
    cfg = CrossCoderConfig(**{**KW, "seq_len": 16}, buffer_device="hbm", shard_lm=True,
                           model_axis_size=2, harvest_runtime="paged", page_size=16)
    with pytest.raises(NotImplementedError, match="ROADMAP A6b item 4b"):
        buf.make_buffer(cfg, None, [{}, {}], TOKENS[:, :16], device="cpu")
    params = lm.init_params(lm.LMConfig.tiny(), seed=0, device="cpu")
    params[lm.TP_KEY] = lm.TPGroup(None, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP A6b item 4b"):
        lm.run_with_cache_multi_paged([params], TOKENS[:2, :16], [16, 16], lm.LMConfig.tiny(),
                                      ["blocks.1.hook_resid_pre"], page_size=8)


@pytest.mark.parametrize("kw", [
    dict(activation="topk", topk_k=4, l1_coeff=0.0, dict_size=256, sparse_bwd="on",
         fused_encoder="on"),
    dict(activation="topk", topk_k=4, l1_coeff=0.0, dict_size=256, sparse_decode=True),
], ids=["fused_topk", "sparse_decode"])
def test_shard_sources_keeps_the_item5_refusals(kw):
    cfg = CrossCoderConfig(d_in=8, batch_size=8, num_tokens=16, log_backend="null",
                           shard_sources=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A6b"):
        Trainer(cfg, device="cpu", mesh=_fake_mesh(1, 2))


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
def test_tp_needs_head_counts_the_axis_divides(m):
    cfg = lm.LMConfig.tiny()            # 4 query heads, 2 KV heads
    with pytest.raises(ValueError, match=r"n_heads 4 and n_kv_heads 2 .* ROADMAP A6b item 4c"):
        lm.check_tp(cfg, m)
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads 2"):
        lm.shard_params_tp(params, _fake_mesh(1, m), cfg)


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

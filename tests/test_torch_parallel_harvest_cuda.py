"""The parallel harvest on the card, at the one grid one card holds: over an
NCCL group of one rank the tensor-parallel LM is bitwise the whole one
(every collective the identity); the mesh-sharded stores, bf16 and int8
(K11 on the refill), serve bitwise the device stores' batches from the
same tokens, and a mesh Trainer on them (K5, K8, K10, O1) steps bitwise
the single-device Trainer on the device store; ``shard_sources`` on a grid
of one steps bitwise the single-device Trainer. Every test needs a CUDA
device and skips without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_harvest_cuda.py

Bars: bitwise."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import adam, quant, sparse_grad as sg, topk_pallas as tp
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
from crosscoder_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

# a narrow two-model harvest: Gemma-2 semantics at d_model 256
LM = lm.LMConfig(vocab_size=1024, d_model=256, n_layers=4, n_heads=8, n_kv_heads=4,
                 head_dim=32, d_ff=512, sliding_window=64)
STORE = dict(d_in=256, n_models=2, hook_point="blocks.2.hook_resid_pre", dict_size=4096,
             topk_k=16, batch_size=256, enc_dtype="bf16", master_dtype="fp32", l1_coeff=0.0,
             activation="topk", sparse_bwd="on", fused_encoder="off", aux_k=0, seq_len=128,
             model_batch_size=4, buffer_mult=8, norm_calib_batches=2, buffer_device="hbm",
             quant_block=64, lr=1e-3, log_backend="null")
STEPS = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A group of one rank over NCCL; what a test builds single-device it
    builds before entering it."""
    import torch.distributed as dist

    def join():
        multihost.initialize("cuda:0", store=dist.FileStore(str(tmp_path / "store"), 1),
                             world_size=1, rank=0)
        assert dist.get_backend() == "nccl"
        return mesh_lib.make_mesh(1, 1)

    yield join
    multihost.shutdown()


def _tokens(n, seq, vocab, seed=5):
    t = np.random.default_rng(seed).integers(3, vocab, size=(n, seq), dtype=np.int64)
    t[:, 0] = 2
    return t


def _params():
    return [lm.init_params(LM, seed=s, device="cuda") for s in (1, 2)]


def _same(a, b):
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def test_tp_forward_at_one_rank_is_bitwise_the_whole_forward(nccl_group):
    params = _params()[0]
    mesh = nccl_group()
    tp_params = lm.shard_params_tp(params, mesh, LM)
    toks = torch.as_tensor(_tokens(2, 128, LM.vocab_size), device="cuda")
    hooks = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out", "blocks.2.hook_mlp_out")
    with torch.no_grad():
        lt, ct = lm.forward(tp_params, toks, LM, capture=hooks)
        lw, cw = lm.forward(params, toks, LM, capture=hooks)
        assert _same(lt, lw)
        for hp in hooks:
            assert _same(ct[hp], cw[hp]), hp
        assert _same(lm.run_with_cache_multi([tp_params], toks, LM, hooks[:1]),
                     lm.run_with_cache_multi([params], toks, LM, hooks[:1]))


@pytest.mark.parametrize("quant_buffer", [False, True], ids=["bf16", "int8"])
def test_mesh_store_and_its_steps_are_bitwise_the_device_store(nccl_group, quant_buffer):
    params = _params()
    tokens = _tokens(64, STORE["seq_len"], LM.vocab_size)
    cfg = CrossCoderConfig(**STORE, quant_buffer=quant_buffer,
                           num_tokens=STORE["batch_size"] * STEPS)
    dev = buf.make_buffer(cfg, LM, params, tokens, device="cuda")
    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    single = Trainer(cfg, dev, device="cuda", state=state0)
    mesh = nccl_group()
    cls = buf.QuantMeshPairedActivationBuffer if quant_buffer else buf.MeshPairedActivationBuffer
    quant.quantize_rows.launches = 0
    mesh_store = cls(cfg, LM, params, tokens, device="cuda", mesh=mesh)
    assert (quant.quantize_rows.launches > 0) == quant_buffer
    assert np.array_equal(mesh_store.normalisation_factor, dev.normalisation_factor)
    for i in range(8):
        assert _same(mesh_store.next_raw(), dev.next_raw()), i
    grid = Trainer(cfg, mesh_store, device="cuda", state=state0, mesh=mesh)
    counters = (tp.topk, tp.sparsify, sg.scatter_add_rows, adam.adam_update)
    grid_launches = [0] * len(counters)         # the mesh path's steps only
    for i in range(STEPS):
        a = single.step()
        for c in counters:
            c.launches = 0
        b = grid.step()
        grid_launches = [n + c.launches for n, c in zip(grid_launches, counters)]
        assert _same(a["loss"], b["loss"]), i
        for k, v in single.state.params.items():
            assert _same(v, grid.state.params[k]), (i, k)
    assert all(n > 0 for n in grid_launches)
    assert grid_launches[-1] == STEPS           # O1 once a step


def test_shard_sources_at_one_rank_is_bitwise_the_single_device_trainer(nccl_group):
    cfg = CrossCoderConfig(**{**STORE, "buffer_device": "host", "aux_k": 32, "aux_every": 2,
                              "aux_dead_steps": 1}, num_tokens=STORE["batch_size"] * STEPS)
    src = SyntheticActivationSource(cfg)
    batches = [torch.from_numpy(src.next()).cuda() for _ in range(STEPS)]

    class Batches:
        def __init__(self):
            self.i = 0

        def next(self):
            self.i += 1
            return batches[self.i - 1]

    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    single = Trainer(cfg, Batches(), device="cuda", state=state0)
    mesh = nccl_group()
    grid = Trainer(cfg.replace(shard_sources=True), Batches(), device="cuda", state=state0,
                   mesh=mesh)
    for i in range(STEPS):
        a, b = single.step(), grid.step()
        assert _same(a["loss"], b["loss"]), i
        for k, v in single.state.params.items():
            assert _same(v, grid.state.params[k]), (i, k)

"""The parallel layer on the card, at the one grid one card holds: a data
1 x model 1 mesh over an NCCL group of one rank runs every collective and
the merge, and its steps are bitwise the single-device Trainer's (TopK
with AuxK through K5, K8 and K10; BatchTopK through K9; ReLU); the int8
gradient exchange through K11 is bitwise the exchange with the plain
quantize, K11 launched twice a leaf. Every test needs a CUDA device and
skips without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Bars: bitwise (a collective over one rank is the identity)."""

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.ops import quant
from crosscoder_tpu_torch.parallel import mesh as mesh_lib
from crosscoder_tpu_torch.parallel import multihost, quant_ar
from crosscoder_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda

BASE = dict(d_in=64, n_models=2, dict_size=4096, batch_size=256, num_tokens=256 * 4,
            enc_dtype="bf16", master_dtype="fp32", lr=1e-3, log_backend="null")
CONFIGS = {
    "topk_auxk": dict(activation="topk", topk_k=16, l1_coeff=0.0, sparse_bwd="on", aux_k=32,
                      aux_dead_steps=1, aux_every=2, fused_encoder="off"),
    "batchtopk": dict(activation="batchtopk", topk_k=16, l1_coeff=0.0, sparse_bwd="off"),
    "relu": dict(activation="relu", l1_coeff=1.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A group of one rank over NCCL; the single-device trainers a test
    builds before entering it."""
    import torch.distributed as dist

    def join():
        multihost.initialize("cuda:0", store=dist.FileStore(str(tmp_path / "store"), 1),
                             world_size=1, rank=0)
        assert dist.get_backend() == "nccl"
        return mesh_lib.make_mesh(1, 1)

    yield join
    multihost.shutdown()


def _bits(t):
    return t.detach().float().reshape(-1).cpu().view(torch.int32).tolist()


class _Batches:
    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def next(self):
        b = self.batches[self.i]
        self.i += 1
        return b


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_rank_nccl_step_is_bitwise_the_single_device_trainer(nccl_group, name):
    cfg = CrossCoderConfig(**BASE, **CONFIGS[name])
    src = SyntheticActivationSource(cfg)
    batches = [torch.from_numpy(src.next()).cuda() for _ in range(4)]
    single = Trainer(cfg, _Batches(batches), device="cuda")
    mesh = nccl_group()
    grid = Trainer(cfg, _Batches(batches), device="cuda", mesh=mesh)
    assert grid.mesh is mesh and single.mesh is None
    for _ in range(4):
        a, b = single.step(), grid.step()
        assert {k: _bits(v) if torch.is_tensor(v) else v for k, v in a.items()} == \
               {k: _bits(v) if torch.is_tensor(v) else v for k, v in b.items()}
        for k, v in single.state.params.items():
            assert torch.equal(v.view(torch.int32), grid.state.params[k].view(torch.int32)), k


def test_exchange_through_k11_is_bitwise_the_plain_exchange(nccl_group):
    mesh = nccl_group()
    gen = torch.Generator(device="cuda").manual_seed(4)
    grads = {"W": torch.randn((4096, 33), generator=gen, device="cuda"),
             "b": torch.randn((1000,), generator=gen, device="cuda")}
    efs = {k: torch.randn((1, quant_ar.padded_len(g.numel(), 1, 256)), generator=gen,
                          device="cuda") * 1e-3 for k, g in grads.items()}
    quant.quantize_rows.launches = 0
    got = {k: quant_ar.quantized_pmean(mesh.data_group, g, efs[k], 256) for k, g in grads.items()}
    assert quant.quantize_rows.launches == 2 * len(grads)
    saved = quant_ar.quantize
    quant_ar.quantize = quant.quantize_blocks
    try:
        want = {k: quant_ar.quantized_pmean(mesh.data_group, g, efs[k], 256)
                for k, g in grads.items()}
    finally:
        quant_ar.quantize = saved
    for k in grads:
        (o1, e1, p1), (o2, e2, p2) = got[k], want[k]
        for a, b in ((o1, o2), (e1, e2), (p1["q"], p2["q"]), (p1["scales"], p2["scales"])):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), k
        assert (o1 - grads[k]).abs().max() < 0.05 * grads[k].abs().max()

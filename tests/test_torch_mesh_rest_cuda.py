"""The kernels of the mesh's last refusals on the card: K4's count entry
bitwise its plain version (bf16 and f32, exact operands, the bisection's
first pass, a pass past the global threshold and one at the bound itself);
K1 at the head counts a tensor-parallel rank launches it with (the KV
heads of one rank of 2, 4 and 8, a query head on one KV head when the
model axis splits a GQA group), against the plain version of the whole
problem's heads at K1's bars; K2 and K3 on dictionary shards, their
candidates merged through the global column offset, bitwise the unsharded
kernel. Every test needs a CUDA device and skips without one; the file
imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_rest_cuda.py

Bars: bitwise (K2, K3, K4); K1 1e-5 in f32, 2e-2 in bf16 on valid rows and
2e-2 of each row's largest output."""

import pytest
import torch

from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _exact(seed, B, nd, width, dtype):
    """Integer-valued K4 operands (exact fp32 sums) with duplicate columns,
    so a pattern is held by many entries."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-3, 4, (B, nd), generator=gen, device="cuda").float()
    W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
    W[:, width // 2] = W[:, 9]
    W[:, width - 8:] = W[:, 100:108]
    b = torch.randint(-4, 5, (width,), generator=gen, device="cuda").float()
    return x.to(dtype), W.to(dtype), b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,nd,width,k", [(48, 128, 1000, 8), (300, 256, 2048 + 8, 32),
                                          (33, 128, 512, 4)])
def test_fused_batchtopk_count_bitwise_matches_plain(cuda, dtype, B, nd, width, k):
    """The count entry on the ranges a grid's threshold walks: the first
    pass from 0, the pass from the exact k-th pattern (every count below the
    budget: the loop's one pass at one rank), a narrow range around it, and
    T of 1 and 32."""
    x, W, b = _exact(B + width, B, nd, width, dtype)
    kk = fek.batchtopk_budget(B, width, k)
    top = 0x7FFF if dtype == torch.bfloat16 else 0x7FFFFFFF
    kth = int(fek.fused_batchtopk_select_plain(x, W, b, kk))
    before = fek.fused_batchtopk_count.launches
    cases = [(0, top, 15), (kth, top, 15), (max(kth - 40, 0), kth + 40, 15), (0, top, 1),
             (kth, kth + 2, 1), (0, top, 32)]
    for lo, hi, t in cases:
        got = fek.fused_batchtopk_count(x, W, b, lo, hi, t)
        want = fek.fused_batchtopk_count_plain(x, W, b, lo, hi, t)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want.cpu()), (lo, hi, t)
    assert fek.fused_batchtopk_count.launches == before + len(cases)
    at_kth = fek.fused_batchtopk_count(x, W, b, kth, top).cpu()
    assert int(at_kth.max()) < kk               # nothing above the exact threshold reaches kk
    with pytest.raises(ValueError, match="lo < hi - 1"):
        fek.fused_batchtopk_count(x, W, b, 5, 6)


def _attention_err(a, b, lengths, H):
    worst = rel = 0.0
    for d, ln in enumerate(lengths):
        x, y = (t[d, :ln].float().reshape(ln, H, -1) for t in (a, b))
        e = (x - y).abs()
        worst = max(worst, e.max().item())
        rel = max(rel, (e.amax(-1) / y.abs().amax(-1).clamp_min(1e-30)).max().item())
    return worst, rel


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("window,softcap", [(0, 50.0), (96, 50.0), (0, 0.0)])
def test_paged_attention_at_a_tensor_parallel_ranks_heads(cuda, dtype, tol, m, window, softcap):
    """Gemma-2-2B's 8 query heads on 4 KV heads of 256 split over ``m``
    model ranks, each rank's launch on its own heads: at 2, 4 query heads on
    2 KV heads; at 4, 2 on 1; at 8, where a rank holds half a KV head's
    width, one query head on its whole gathered KV head (a group of 1). The
    ranks' outputs side by side equal the plain version of the whole
    problem at K1's bars."""
    H, KV, hd, page, S = 8, 4, 256, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(m + window)
    lengths = [1, page - 1, page + 1, 200, S]
    q = torch.randn((len(lengths), S, H, hd), generator=gen, device="cuda")
    k, v = (torch.randn((len(lengths), S, KV, hd), generator=gen, device="cuda")
            for _ in range(2))
    if dtype == torch.bfloat16 and softcap:
        q, v = q * 30, v / 4
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    kw = dict(page_size=page, scale=hd ** -0.5, softcap=softcap, window=window)
    outs = []
    before = pa.paged_attention.launches
    for r in range(m):
        h0, h1 = r * H // m, (r + 1) * H // m
        if KV % m == 0:                             # head-local: this rank's KV heads
            kv = torch.arange(r * KV // m, (r + 1) * KV // m, device="cuda")
        else:                                       # one KV head a query head
            kv = torch.arange(h0, h1, device="cuda") // (H // KV)
        outs.append(pa.paged_attention(q[:, :, h0:h1].contiguous(), k.index_select(2, kv),
                                       v.index_select(2, kv), lens, **kw))
    assert pa.paged_attention.launches == before + m
    got = torch.cat(outs, dim=-1)
    want = pa.paged_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    worst, rel = _attention_err(got, want, lengths, H)
    assert worst <= tol, worst
    assert dtype == torch.float32 or rel <= tol, rel


def _planted(seed, B, nd, width, dtype):
    """Integer-valued K2/K3 operands with exact ties inside a shard and
    across shards, and a row of -0.0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-3, 4, (B, nd), generator=gen, device="cuda").float()
    W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
    b = torch.randint(-4, 5, (width,), generator=gen, device="cuda").float()
    W[:, 600:640] = W[:, 10:50]
    b[600:640] = b[10:50]
    W[:, width - 100] = W[:, 20]                    # a tie across the shards
    b[width - 100] = b[20]
    x[2] = -0.0
    return x.to(dtype), W.to(dtype), b


class _Shards:
    """A stand-in grid of ``m`` model ranks for :func:`cc._merge_keep`:
    ``gather_model`` hands back every shard's keys, stacked."""

    def __init__(self, keys, rank):
        self.keys, self.model_rank = keys, rank

    def gather_model(self, key):
        assert torch.equal(key, self.keys[self.model_rank])
        return torch.stack(self.keys)


def _merged(encode, x, W, b, k, m):
    """Each shard's (vals, idx) through ``encode``, cut to the row's global
    top k by the mesh merge (the global column offset in its key), as
    ``{(row, global column): value}``."""
    width = W.shape[1] // m
    shards = [encode(x, W[:, r * width:(r + 1) * width].contiguous(),
                     b[r * width:(r + 1) * width].contiguous(), k) for r in range(m)]
    keys = [cc._order_key(v, i.to(torch.int64) + r * width) for r, (v, i) in enumerate(shards)]
    out = {}
    for r, (vals, idx) in enumerate(shards):
        keep = cc._merge_keep(vals, idx, k, _Shards(keys, r), width)
        kept = torch.where(keep, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
        for row, col, val in zip(*torch.nonzero(kept > 0, as_tuple=True),
                                 kept[kept > 0].float().tolist()):
            out[(int(row), int(idx[row, col]) + r * width)] = val
    return out


def _as_dict(vals, idx):
    return {(int(r), int(idx[r, c])): v for r, c, v in
            zip(*torch.nonzero(vals > 0, as_tuple=True), vals[vals > 0].float().tolist())}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("quant_block", [0, 128])
def test_fused_topk_on_dictionary_shards_merges_to_the_unsharded_kernel(cuda, dtype, m,
                                                                        quant_block):
    """K2 (``quant_block`` 0) and K3 (128) on ``m`` shards of a 4096-wide
    dictionary, merged through the global column offset, equal the kernel
    on the whole dictionary: the same entries with the same bits (K3's
    scales are per column and per row block, so a shard quantizes its
    columns as the whole does)."""
    B, nd, width, k = 40, 256, 4096, 32
    x, W, b = _planted(m + quant_block, B, nd, width, dtype)

    def encode(x, W, b, k):
        return fek.fused_topk_encode(x, W, b, k, quant_block=quant_block)

    counter = fek.fused_topk_encode_q if quant_block else fek.fused_topk_encode
    before = counter.launches
    got = _merged(encode, x, W, b, k, m)
    want = _as_dict(*encode(x, W, b, k))
    torch.cuda.synchronize()
    assert counter.launches == before + m + 1
    assert got == want and len(want) > B * k // 2

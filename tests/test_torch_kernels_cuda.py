"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode); the file imports no JAX, so the card's machine
runs it as is:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: paged attention 1e-5 in fp32 and 2e-2 in bf16 on valid rows
(online softmax reassociates the sum; the plain version rounds the
probabilities to bf16); the fused encoder→TopK bitwise on integer-valued
operands, whose fp32 sums are exact in any order."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.serve.smoke import build_engine, oracle, serve_batch, serve_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # parity in full fp32
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,page,heads", [(256, 64, (8, 4)), (128, 32, (4, 4)),
                                           (256, 32, (16, 4)), (128, 64, (8, 2))])
@pytest.mark.parametrize("window", [0, 96])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, hd, page, heads, window):
    H, KV = heads
    gen = torch.Generator(device="cuda").manual_seed(hd + page + H)
    lengths = [1, page - 1, page, page + 1, 200, 256]
    q = torch.randn((len(lengths), 256, H, hd), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((len(lengths), 256, KV, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    kw = dict(page_size=page, scale=hd ** -0.5, softcap=50.0, window=window)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, lens, **kw)
    want = pa.paged_attention_plain(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    for d, ln in enumerate(lengths):
        err = (got[d, :ln].float() - want[d, :ln].float()).abs().max().item()
        assert err <= tol, (d, err)


def test_paged_attention_kernel_rejects_unsupported(cuda):
    q = torch.zeros((1, 64, 4, 64), device="cuda")
    kv = torch.zeros((1, 64, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, kv, kv, torch.ones(1, device="cuda"), page_size=32, scale=1.0)


def _planted(seed, B=12, nd=256, width=2048 + 128):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, size=(B, nd)).astype(np.float32)
    W = rng.integers(-2, 3, size=(nd, width)).astype(np.float32)
    b = rng.integers(-4, 5, size=(width,)).astype(np.float32)
    W[:, 600:640] = W[:, 10:50]          # exact ties
    b[600:640] = b[10:50]
    W[:, width - 1] = W[:, 3]            # a tie across the tail tile
    b[width - 1] = b[3]
    x[1] = np.nan
    x[2] = -0.0
    b[700] = -0.0
    b[800] = np.nan
    return (torch.from_numpy(a).cuda() for a in (x, W, b))


@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [12, 3])
def test_fused_topk_kernel_bitwise_matches_plain(cuda, k, dtype, B):
    x, W, b = _planted(k, B=B)
    x, W = x.to(dtype), W.to(dtype)
    before = fek.fused_topk_encode.launches
    vals, idx = fek.fused_topk_encode(x, W, b, k)
    pv, pi = fek.fused_topk_encode_plain(x, W, b, k)
    torch.cuda.synchronize()
    assert fek.fused_topk_encode.launches == before + 1
    assert torch.equal(idx, pi)
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(vals.view(view), pv.view(view))


def test_serve_path_on_the_card(cuda):
    """A small Gemma-2-shaped stack (head_dim 128, fp32) served on the card
    agrees with the plain re-run and the padded forward, and both kernels
    launched."""
    lm_cfg = lm.LMConfig(vocab_size=512, d_model=256, n_layers=4, n_heads=4, n_kv_heads=2,
                         head_dim=128, d_ff=512, sliding_window=64,
                         query_pre_attn_scalar=128.0, dtype="fp32")
    eng, cfg, _, _, _ = build_engine(serve_max_batch=8, seq_len=128, lm_cfg=lm_cfg,
                                     device="cuda", page_size=32, dict_size=1024, topk_k=16)
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 512, size=n, dtype=np.int32) for n in (1, 128, 33, 64, 65, 7)]
    pa.paged_attention.launches = 0
    fek.fused_topk_encode.launches = 0
    res = serve_batch(eng, docs)
    assert pa.paged_attention.launches == 2 * 3 and fek.fused_topk_encode.launches == 1
    vals, idx, diff, _ = serve_plain(eng, docs)
    tokens = np.zeros((len(docs), 128), np.int64)
    for i, d in enumerate(docs):
        tokens[i, : len(d)] = d
    ovals, oidx, _ = oracle(eng, tokens, [len(d) for d in docs])
    for i, r in enumerate(res):
        np.testing.assert_array_equal(r.idx, idx[i])
        np.testing.assert_array_equal(r.idx, oidx[i])
        np.testing.assert_allclose(r.vals, vals[i], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r.vals, ovals[i], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(r.diff, diff[i])

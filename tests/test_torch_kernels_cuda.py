"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode); the file imports no JAX, so the card's machine
runs it as is:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: paged attention 1e-5 in fp32 (the CUDA-core kernel) and 2e-2
in bf16 (the tensor-core kernel) on valid rows, bf16 also to 2e-2 of
each row's largest output (online softmax reassociates the sum; the plain version rounds the normalized
probabilities to bf16, the bf16 kernel the unnormalized ones); the fused
encoder→TopK (K2) and →BatchTopK (K4) bitwise on integer-valued operands,
whose fp32 sums are exact in any order (bf16 on the tensor-core tile,
also at its edges: rows, contraction and width that are not tile
multiples); the int8 fused encoder (K3, on the int8 tensor-core tile,
also at its edges), the TopK masks (K5, K6, K7 on both its routes and at
every cluster size), the sparsify drain (K8, both routes), the int8
quantize (K11, both routes) and the sorted-pair scatter (K10) bitwise on
any inputs, since each does the plain version's arithmetic in its order
(K11's NaN scales compared as NaN, whatever their payload)."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
from crosscoder_tpu_torch.ops import paged_attention as pa
from crosscoder_tpu_torch.ops import quant, sparse_grad, topk_pallas
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.serve.smoke import build_engine, oracle, serve_batch, serve_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # parity in full fp32
    torch.backends.cudnn.allow_tf32 = False


def _attention_err(a, b, lengths, H):
    """max |a - b| on valid rows, and its largest ratio, row by row (a
    query position and head), to max |b| of the row."""
    worst = rel = 0.0
    for d, ln in enumerate(lengths):
        x, y = (t[d, :ln].float().reshape(ln, H, -1) for t in (a, b))
        e = (x - y).abs()
        worst = max(worst, e.max().item())
        rel = max(rel, (e.amax(-1) / y.abs().amax(-1).clamp_min(1e-30)).max().item())
    return worst, rel


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hd,page,heads", [(256, 64, (8, 4)), (128, 32, (4, 4)),
                                           (256, 32, (16, 4)), (128, 64, (8, 2)),
                                           (128, 64, (8, 1)), (256, 32, (8, 1))])
@pytest.mark.parametrize("window", [0, 96, 4096, 20])
@pytest.mark.parametrize("softcap", [50.0, 0.0])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, hd, page, heads, window, softcap):
    """GQA groups 1, 2, 4 and 8, softcap on and off, global, windowed, a
    window past the sequence and one shorter than a page; lengths 1, around
    a page, S - 1 and S; at page 32, S = 224, which the bf16 kernel's
    64-row tile of one head does not divide. bf16 runs the tensor-core
    kernel, f32 the CUDA-core one. f32 is held to 1e-5 on valid rows; bf16
    to 2e-2 there and, row by row, to 2e-2 of the row's largest output.
    Random logits are about N(0, 1), where a cap of 50 moves a bf16 output
    by less than an ulp, so bf16's softcap cases take sharp logits (q x 30)
    and v / 4 (outputs below 2); every softcap case shows first that the
    cap moves the plain output by over 5x the bar."""
    H, KV = heads
    S = 256 if page == 64 else 224
    gen = torch.Generator(device="cuda").manual_seed(hd + page + H + KV)
    lengths = [1, page - 1, page, page + 1, 200, S - 1, S]
    q = torch.randn((len(lengths), S, H, hd), generator=gen, device="cuda")
    k, v = (torch.randn((len(lengths), S, KV, hd), generator=gen, device="cuda")
            for _ in range(2))
    if dtype == torch.bfloat16 and softcap:
        q, v = q * 30, v / 4
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    kw = dict(page_size=page, scale=hd ** -0.5, softcap=softcap, window=window)
    route = pa.kernel_route(dtype)
    assert route == ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    before = (pa.paged_attention.launches, dict(pa.paged_attention.by_route))
    got = pa.paged_attention(q, k, v, lens, **kw)
    assert (pa.paged_attention.launches, pa.paged_attention.last_route) == (before[0] + 1, route)
    assert pa.paged_attention.by_route == {**before[1], route: before[1][route] + 1}
    want = pa.paged_attention_plain(q, k, v, lens, **kw)
    if softcap:
        uncapped = pa.paged_attention_plain(q, k, v, lens, **{**kw, "softcap": 0.0})
        assert _attention_err(uncapped, want, lengths, H)[0] > 5 * tol
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    worst, rel = _attention_err(got, want, lengths, H)
    assert worst <= tol, worst
    assert dtype == torch.float32 or rel <= tol, rel


def test_paged_attention_kernel_rejects_unsupported(cuda):
    q = torch.zeros((1, 64, 4, 64), device="cuda")
    kv = torch.zeros((1, 64, 2, 64), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, kv, kv, torch.ones(1, device="cuda"), page_size=32, scale=1.0)


def _at_offset(x, shift):
    """``x``'s values in a view ``shift`` elements into a larger buffer."""
    buf = torch.zeros(x.numel() + shift, dtype=x.dtype, device=x.device)
    view = buf[shift:].view(x.shape)
    view.copy_(x)
    return view


def _no_pool(*_, **__):
    raise AssertionError("the card path built a page pool")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("page", [32, 64])
@pytest.mark.parametrize("window,softcap", [(0, 50.0), (96, 50.0), (0, 0.0)])
def test_paged_attention_kernel_27b_geometry(cuda, monkeypatch, dtype, tol, page, window,
                                             softcap):
    """Gemma-2-27B's heads (32 over 16 KV heads of 128) at its query scale
    144^-0.5 (1/12: q * scale rounds in bf16, where 2B's 1/16 is exact);
    lengths 0, 1, page - 1, page, page + 1, S - 1 and S in one batch; q, k
    and v as views at storage offsets of 8, 3 and 24 elements (k's is not
    16-byte aligned in either dtype, so it is copied; q and v are read
    where they lie). No page pool is built. Bars as
    test_paged_attention_kernel_matches_plain's, sharp logits in bf16's
    softcap cases; a document of length 0 comes out as zeros."""
    monkeypatch.setattr(pa, "paginate_kv", _no_pool)
    H, KV, hd = 32, 16, 128
    S = 7 * page
    lengths = [0, 1, page - 1, page, page + 1, S - 1, S]
    gen = torch.Generator(device="cuda").manual_seed(27 + page)
    q = torch.randn((len(lengths), S, H, hd), generator=gen, device="cuda")
    k, v = (torch.randn((len(lengths), S, KV, hd), generator=gen, device="cuda")
            for _ in range(2))
    if dtype == torch.bfloat16 and softcap:
        q, v = q * 30, v / 4
    q, k, v = (_at_offset(x.to(dtype), s) for x, s in ((q, 8), (k, 3), (v, 24)))
    assert [x.storage_offset() for x in (q, k, v)] == [8, 3, 24]
    lens = torch.tensor(lengths, device="cuda", dtype=torch.int32)
    kw = dict(page_size=page, scale=144 ** -0.5, softcap=softcap, window=window)
    before = pa.paged_attention.by_route[pa.kernel_route(dtype)]
    got = pa.paged_attention(q, k, v, lens, **kw)
    assert pa.paged_attention.by_route[pa.kernel_route(dtype)] == before + 1
    want = pa.paged_attention_plain(q, k, v, lens, **kw)
    if softcap:
        uncapped = pa.paged_attention_plain(q, k, v, lens, **{**kw, "softcap": 0.0})
        assert _attention_err(uncapped, want, lengths[1:], H)[0] > 5 * tol
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert not got[0].any()
    worst, rel = _attention_err(got[1:], want[1:], lengths[1:], H)
    assert worst <= tol, worst
    assert dtype == torch.float32 or rel <= tol, rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_attention_card_path_builds_no_page_pool(cuda, monkeypatch, dtype):
    """K and V are read where they lie: with ``paginate_kv`` made to raise
    the call still runs, and at the serve shape (8 documents of 1024, 8
    heads over 4 of 256) the call's peak allocation is its output and the
    lengths, not the 32 MB a pool of K and V would take."""
    monkeypatch.setattr(pa, "paginate_kv", _no_pool)
    D, S, H, KV, hd = 8, 1024, 8, 4, 256
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((D, S, H, hd), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((D, S, KV, hd), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.tensor([1, 1024, 517, 64, 300, 999, 2, 800], device="cuda", dtype=torch.int32)
    kw = dict(page_size=64, scale=256 ** -0.5, softcap=50.0)
    pa.paged_attention(q, k, v, lens, **kw)            # built and loaded before the count
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = pa.paged_attention(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= got.numel() * got.element_size() + 2 ** 20, peak
    worst, rel = _attention_err(got, pa.paged_attention_plain(q, k, v, lens, **kw),
                                lens.tolist(), H)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert worst <= tol and (dtype == torch.float32 or rel <= tol), (worst, rel)


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


def _planted_bf16(seed, R, W):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randint(-6, 7, (R, W), generator=gen, device="cuda").float()
    h[0, : W // 2] = 5.0                  # ties far wider than k
    h[1] = -1.0
    h[1, 3] = 2.0                         # fewer than k positives
    h[2] = -0.0
    h[3, 5] = float("nan")
    h = h.to(torch.bfloat16)
    bits = h.view(torch.int16)
    bits[4, 7], bits[4, 9], bits[4, 11] = -1, 0x7FFF, -64    # 0xFFFF, 0x7FFF, 0xFFC0
    return h


def _same_bits(a, b):
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("k,width", [(32, 2 ** 17 + 128), (128, 2 ** 15 + 128),
                                     (64, 2 ** 16 + 128)])
def test_fused_topk_kernel_two_level_merge_bitwise_matches_plain(cuda, k, width):
    """Wide dictionaries: a row's candidates exceed shared memory and the
    merge takes a first level over groups of tiles."""
    x, W, b = _planted(k + width, B=12, nd=256, width=width)
    x, W = x.to(torch.bfloat16), W.to(torch.bfloat16)
    assert -(-width // fek._CW) > fek._merge_group(k)
    vals, idx = fek.fused_topk_encode(x, W, b, k)
    pv, pi = fek.fused_topk_encode_plain(x, W, b, k)
    assert torch.equal(idx, pi)
    assert torch.equal(vals.view(torch.int16), pv.view(torch.int16))


@pytest.mark.parametrize("R,W", [(16, 512), (37, 1920), (5, 1000), (4096, 32768), (8, 65536)])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_mask_and_sparsify_kernels_bitwise_match_plain(cuda, R, W, k):
    h = _planted_bf16(R + W + k, R, W)
    before = (topk_pallas.topk.launches, topk_pallas.sparsify.launches)
    f = topk_pallas.topk(h, k)
    assert _same_bits(f, topk_pallas.topk_plain(h, k))
    vals, idx = topk_pallas.sparsify(f, k)
    pv, pi = topk_pallas.sparsify_plain(f, k)
    assert _same_bits(vals, pv) and torch.equal(idx, pi)
    f32 = f.float()
    f32[0, ::3] = 1.0                     # a row far past k
    vals, idx = topk_pallas.sparsify(f32, k)
    pv, pi = topk_pallas.sparsify_plain(f32, k)
    assert _same_bits(vals, pv) and torch.equal(idx, pi)
    assert (topk_pallas.topk.launches, topk_pallas.sparsify.launches) == (before[0] + 1,
                                                                          before[1] + 2)


def test_topk_kernel_rejects_other_dtypes_and_bad_k(cuda):
    with pytest.raises(ValueError, match="bf16 or f32"):
        topk_pallas.topk(torch.zeros((2, 512), device="cuda", dtype=torch.float16), 4)
    with pytest.raises(ValueError, match="0 < k <= width"):
        topk_pallas.topk(torch.zeros((2, 2 ** 17), device="cuda", dtype=torch.bfloat16), 0)


def _planted_wide(seed, R, W, dtype):
    """Integer-valued rows for K6/K7: ties wider than k, ties straddling
    any stretch boundary and far from the kth column, rows with fewer than
    k positives, -0.0, +inf, NaN of both signs (f32: a NaN beside +inf in
    a row's top k, where K7 keeps k entries at +inf besides, ROADMAP C6)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randint(-6, 7, (R, W), generator=gen, device="cuda").float()
    planted = [lambda: h[0, : W // 2].fill_(5.0),
               lambda: (h[1].fill_(-1.0), h[1, 3].fill_(2.0)),
               lambda: h[2].fill_(-0.0),
               lambda: (h[3, 4091:4101].fill_(9.0), h[3, W - 3:].fill_(9.0)),
               lambda: (h[4, 7].fill_(float("inf")), h[4, W - 1].fill_(float("inf")),
                        h[4, 9].fill_(float("nan"))),
               lambda: h[5, W - 40:].fill_(8.0)]
    for row in planted[:R]:
        row()
    h = h.to(dtype)
    if R > 6:
        if dtype == torch.bfloat16:
            h.view(torch.int16)[6, 11] = -64                     # 0xFFC0
            h.view(torch.int16)[6, 12] = 0x7FFF
        else:
            h.view(torch.int32)[6, 11] = -4194304                # 0xFFC00000
            h.view(torch.int32)[6, 12] = 0x7FC00001
    return h


@pytest.mark.parametrize("R,W", [(16, 512), (37, 384), (4096, 16384), (9, 26624), (5, 1000)])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_f32_kernel_bitwise_matches_plain(cuda, R, W, k):
    h = _planted_wide(R + W + k, R, W, torch.float32)
    before = topk_pallas.topk_mask_f32.launches
    got = topk_pallas.topk_mask_f32(h, k)
    assert _same_bits(got, topk_pallas.topk_plain(h, k))
    assert topk_pallas.topk_mask_f32.launches == before + 1
    if topk_pallas.topk_route(W, k, torch.float32) == "K6":
        assert _same_bits(topk_pallas.topk(h, k), got)
        assert topk_pallas.topk_mask_f32.launches == before + 2


@pytest.mark.parametrize("dtype,R,W", [
    (torch.bfloat16, 8, 2 ** 17), (torch.bfloat16, 5, 2 ** 16 + 384),
    (torch.bfloat16, 7, 70001), (torch.bfloat16, 4096, 2 ** 17),
    (torch.float32, 16, 32768), (torch.float32, 7, 28672 + 8), (torch.float32, 4096, 32768),
    (torch.float32, 9, 1000), (torch.bfloat16, 9, 512)])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_chunked_kernel_bitwise_matches_plain(cuda, dtype, R, W, k):
    h = _planted_wide(R + W + k, R, W, dtype)
    before = topk_pallas.topk_chunked.launches
    got = topk_pallas.topk_chunked(h, k)
    assert _same_bits(got, topk_pallas.topk_chunked_plain(h, k))
    assert topk_pallas.topk_chunked.launches == before + 1
    if topk_pallas.topk_route(W, k, dtype) == "K7":
        assert _same_bits(topk_pallas.topk(h, k), got)
        assert topk_pallas.topk_chunked.launches == before + 2
    if dtype == torch.float32 and k == 1 and R > 4:
        assert int((got[4] != 0).sum()) == 2                   # C6: the NaN and one +inf


def _planted_slices(seed, R, W, dtype):
    """Integer-valued rows whose ties straddle the edges of the slices
    topk_plan cuts (row 3 at 9, a wide run at 7 in row 4, so that k = 32
    keeps ties from two slices), besides _planted_wide's cases."""
    h = _planted_wide(seed, R, W, dtype).float()
    _, n, S = topk_pallas.topk_plan(W, dtype)
    for e in range(S, W, S) if n > 1 else (W // 2,):
        h[3, max(e - 3, 0): e + 3] = 9.0
        h[4, max(e - 20, 0): e + 20] = 7.0
    out = h.to(dtype)
    if R > 6:                                                   # _planted_wide's NaN row
        src = _planted_wide(seed, R, W, dtype)
        out[6] = src[6]
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_blocks", range(1, topk_pallas._MAX_CLUSTER + 1))
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("k", [1, 32, "W"])
def test_topk_cluster_route_at_each_cluster_size(cuda, dtype, n_blocks, ragged, k):
    """K7's cluster route at every cluster size the plan uses, full slices
    and a ragged last slice, bitwise against the plain version and the
    plain model of the slicing."""
    per = topk_pallas._SLICE_BYTES // (2 if dtype == torch.bfloat16 else 4)
    W = n_blocks * per - (24 if ragged else 0)
    k = W if k == "W" else k
    assert topk_pallas.topk_plan(W, dtype)[:2] == ("cluster", n_blocks)
    h = _planted_slices(n_blocks + k, 7, W, dtype)
    before = dict(topk_pallas.topk_chunked.by_route)
    got = topk_pallas.topk_chunked(h, k)
    assert _same_bits(got, topk_pallas.topk_chunked_plain(h, k))
    assert _same_bits(got, topk_pallas.topk_sliced_plain(h, k, n_blocks,
                                                         topk_pallas._CHUNKED_TOP[dtype]))
    assert topk_pallas.topk_chunked.by_route == {**before, "cluster": before["cluster"] + 1}
    if k == 32:
        assert int((got[4] != 0).sum()) == 32


@pytest.mark.parametrize("dtype,W,route", [
    (torch.bfloat16, 2 ** 18, "cluster"), (torch.bfloat16, 2 ** 18 + 8, "streaming"),
    (torch.bfloat16, 2 ** 18 + 3, "streaming"), (torch.float32, 2 ** 17, "cluster"),
    (torch.float32, 2 ** 17 + 8, "streaming"), (torch.float32, 2 ** 17 - 5, "cluster")])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_chunked_routes_on_both_sides_of_the_cluster_reach(cuda, dtype, W, route, k):
    h = _planted_slices(W + k, 6, W, dtype)
    assert topk_pallas.topk_plan(W, dtype)[0] == route
    before = (topk_pallas.topk_chunked.launches, dict(topk_pallas.topk_chunked.by_route))
    got = topk_pallas.topk_chunked(h, k)
    assert _same_bits(got, topk_pallas.topk_chunked_plain(h, k))
    assert topk_pallas.topk_chunked.launches == before[0] + 1
    assert topk_pallas.topk_chunked.by_route == {**before[1], route: before[1][route] + 1}


@pytest.mark.parametrize("W", [256, 2 ** 16, 1001, 32768 + 4])
@pytest.mark.parametrize("k", [1, 32, "W"])
def test_topk_mask_kernel_widths_bitwise_match_plain(cuda, W, k):
    """K5 (one block a row on topk_slice.cuh) at its narrowest and widest
    rows, and at widths that are not a multiple of 8 (no bulk copy)."""
    k = W if k == "W" else k
    h = _planted_slices(W + k, 9, W, torch.bfloat16)
    before = topk_pallas.topk.launches
    got = topk_pallas.topk_mask(h, k)
    assert _same_bits(got, topk_pallas.topk_plain(h, k))
    assert _same_bits(got, topk_pallas.topk_sliced_plain(h, k, 1, None))
    assert topk_pallas.topk.launches == before + 1


def test_topk_cluster_launch_refuses_a_cluster_past_eight(cuda):
    """A cluster shape the kernel does not take raises; nothing falls back."""
    from crosscoder_tpu_torch.ops import _build

    h = torch.ones((4, 2 ** 18), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(_build.KernelLaunchError):
        topk_pallas._launch_mask("topk_chunked", "topk_cluster_launch", h, 4, (2 ** 15, 9, 1))


def test_scatter_counter_stays_the_wrappers_under_a_stand_in(cuda, monkeypatch):
    """A function bound to the module's name in the wrapper's place (as
    chip_smoke.py's ScatterCalls is) leaves the count on the wrapper."""
    real = sparse_grad.scatter_add_rows
    calls = []

    def stand_in(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(sparse_grad, "scatter_add_rows", stand_in)
    cf = torch.ones((8, 2), device="cuda")
    idx = torch.arange(16, device="cuda", dtype=torch.int32).reshape(8, 2)
    before = real.launches
    sparse_grad.scatter_add_rows(cf, idx, torch.ones((8, 128), device="cuda"), 16)
    assert (len(calls), real.launches) == (1, before + 1)
    assert not hasattr(stand_in, "launches")


@pytest.mark.parametrize("B,k,n_out,m,dtype", [
    (16, 4, 512, 128, torch.float32), (32, 8, 1920, 130, torch.bfloat16),
    (4096, 32, 32768, 4608, torch.float32), (4096, 64, 32768, 4608, torch.float32),
    (4096, 32, 32768, 4736, torch.bfloat16)])
def test_scatter_kernel_bitwise_matches_plain(cuda, B, k, n_out, m, dtype):
    gen = torch.Generator(device="cuda").manual_seed(B + k + m)
    cf = torch.randn((B, k), generator=gen, device="cuda")
    idx = torch.randint(0, n_out, (B, k), generator=gen, device="cuda", dtype=torch.int32)
    idx[:, 0] = 3                         # a latent hit by every row
    idx[0, 1], idx[1, 1] = -1, n_out      # dropped
    rows = torch.randn((B, m), generator=gen, device="cuda").to(dtype)
    before = sparse_grad.scatter_add_rows.launches
    got = sparse_grad.scatter_add_rows(cf, idx, rows, n_out)
    want = sparse_grad.scatter_add_rows_plain(cf, idx, rows, n_out)
    assert sparse_grad.scatter_add_rows.launches == before + 1
    assert _same_bits(got, want)


def _planted_bt(seed, R, W, dtype):
    """BatchTopK inputs: integer-valued rows (exact ties at the threshold),
    an all-negative row, -0.0, NaN of both signs, +inf."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randint(-40, 41, (R, W), generator=gen, device="cuda").float() / 4
    h[1] = -1.0
    h[2, : W // 3] = -0.0
    h[3, 5] = float("inf")
    h[4, 9] = float("nan")
    h = h.to(dtype)
    if dtype == torch.bfloat16:
        h.view(torch.int16)[5, 11] = -64                    # 0xFFC0, a negative NaN
    else:
        h.view(torch.int32)[5, 11] = -4194304               # 0xFFC00000
    return h


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,W,k", [(4096, 32768, 32), (37, 2304 + 128, 5), (6, 1000, 1),
                                   (16, 512, 512), (6, 13, 2)])
def test_batchtopk_kernels_bitwise_match_plain(cuda, dtype, R, W, k):
    h = _planted_bt(R + W + k, R, W, dtype)
    kk = topk_pallas.batchtopk_budget(h, k)
    before = (topk_pallas.batchtopk_select.launches, topk_pallas.batchtopk_emit.launches)
    kth = topk_pallas.batchtopk_select(h, kk)
    want = topk_pallas.batchtopk_select_plain(h, kk)
    assert int(kth) == int(want), (int(kth), int(want))
    out = topk_pallas.batchtopk(h, k)
    assert _same_bits(out, topk_pallas.batchtopk_emit_plain(h, want))
    for thr in (0.5, 3.0, 0.0, -1.0):
        assert _same_bits(topk_pallas.batchtopk_fixed(h, thr),
                          topk_pallas.batchtopk_emit_plain(
                              h, torch.tensor([topk_pallas.fixed_threshold_pattern(thr, dtype)],
                                              device="cuda")))
    assert (topk_pallas.batchtopk_select.launches, topk_pallas.batchtopk_emit.launches) == (
        before[0] + 2, before[1] + 5)


def test_batchtopk_kernel_all_negative_and_budget_above_positives(cuda):
    h = -torch.ones((64, 4096), device="cuda", dtype=torch.bfloat16)
    assert int(topk_pallas.batchtopk_select(h, 64 * 8)) == 0
    assert int(topk_pallas.batchtopk(h, 8).view(torch.int16).abs().max()) == 0
    h[3, 7], h[9, 1] = 2.0, 3.0
    out = topk_pallas.batchtopk(h, 8)
    assert int((out > 0).sum()) == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,W,block", [(4092 * 2, 2304, 256), (33, 512, 128), (7, 96, 32),
                                       (5, 64, 8)])
def test_quantize_rows_kernel_bitwise_matches_plain(cuda, dtype, R, W, block):
    from crosscoder_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(R + W)
    x = torch.randn((R, W), generator=gen, device="cuda") * 7
    x[0, :block] = 0.0                                       # an all-zero block
    x[1, :block] = (torch.arange(block, device="cuda") % 20 - 9.5)
    x[1, 0] = 127.0                                          # scale 1: exact half-way quotients
    x[2, 3] = float("nan")
    x = x.to(dtype)
    before = quant.quantize_rows.launches
    q, s = quant.quantize_rows(x, block)
    pq, ps = quant.quantize_blocks(x, block)
    torch.cuda.synchronize()
    assert quant.quantize_rows.launches == before + 1
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32)) or (
        torch.equal(torch.isnan(s), torch.isnan(ps))
        and torch.equal(s[~torch.isnan(s)], ps[~torch.isnan(ps)]))


def test_sparse_train_step_on_the_card(cuda):
    """Three AuxK-enabled sparse TopK steps (bare and aux variants) on the
    card: finite losses, l0 <= k, and K5, K8 and K10 all launched."""
    cfg = CrossCoderConfig(d_in=256, dict_size=4096, batch_size=256, activation="topk",
                           topk_k=16, l1_coeff=0.0, sparse_bwd="on", aux_k=32,
                           aux_every=2, aux_dead_steps=1, num_tokens=256 * 4,
                           log_backend="null")
    counters = (topk_pallas.topk, topk_pallas.sparsify, sparse_grad.scatter_add_rows)
    before = [c.launches for c in counters]
    tr = Trainer(cfg, device="cuda")
    for _ in range(3):
        m = tr.step()
        assert torch.isfinite(m["loss"]) and float(m["l0_loss"]) <= cfg.topk_k
    assert all(c.launches > b for c, b in zip(counters, before))


def _int_bt(seed, B, nd, width, dtype, bias=None):
    """Integer-valued K4 operands (exact fp32 sums), with an exact tie at a
    column pair that sits at the global threshold for the budgets used."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-3, 4, (B, nd), generator=gen, device="cuda").float()
    W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
    W[:, width // 2] = W[:, 9]
    b = (torch.randint(-2, 3, (width,), generator=gen, device="cuda").float()
         if bias is None else torch.full((width,), bias, device="cuda"))
    return x.to(dtype), W.to(dtype), b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,nd,width,k,bias", [(48, 128, 1000, 8, None), (33, 128, 512, 4, 3.0),
                                               (300, 256, 2048 + 8, 32, None),
                                               (20, 128, 256, 256, -1.0)])
def test_fused_batchtopk_kernels_bitwise_match_plain(cuda, dtype, B, nd, width, k, bias):
    """K4 on exact inputs: a tie at the global threshold, a positive bias
    with rows that are not a tile multiple (padded rows must not count), a
    width that is not a tile multiple, and a budget above the positives."""
    x, W, b = _int_bt(B + width + k, B, nd, width, dtype, bias)
    kk = fek.batchtopk_budget(B, width, k)
    before = (fek.fused_batchtopk_select.launches, fek.fused_batchtopk_emit.launches)
    kth = fek.fused_batchtopk_select(x, W, b, kk)
    want = fek.fused_batchtopk_select_plain(x, W, b, kk)
    torch.cuda.synchronize()
    assert int(kth) == int(want), (int(kth), int(want))
    out = fek.fused_batchtopk_encode(x, W, b, k)
    assert _same_bits(out, fek.fused_batchtopk_encode_plain(x, W, b, k))
    assert _same_bits(fek.fused_batchtopk_emit(x, W, b, want), out)
    assert (fek.fused_batchtopk_select.launches, fek.fused_batchtopk_emit.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,qb", [(12, 128), (130, 256)])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_fused_topk_q_kernel_bitwise_matches_plain(cuda, dtype, B, qb, k):
    """K3 on random inputs: the int8 products are exact, and the kernel
    rounds the fold as the plain version does, so any input is bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(B + qb + k)
    nd, width = 512, 4096 + 96
    x = torch.randn((B, nd), generator=gen, device="cuda").to(dtype)
    W = (torch.randn((nd, width), generator=gen, device="cuda") * 0.05).to(dtype)
    b = torch.randn((width,), generator=gen, device="cuda") * 0.01
    before = fek.fused_topk_encode_q.launches
    vals, idx = fek.fused_topk_encode(x, W, b, k, quant_block=qb)
    pv, pi = fek.fused_topk_encode_q_plain(x, W, b, k, qb)
    torch.cuda.synchronize()
    assert fek.fused_topk_encode_q.launches == before + 1
    assert torch.equal(idx, pi)
    assert _same_bits(vals, pv)


# the contraction for each quant block: 544 and 576 leave a partial last stage;
# 288 and 384 span three stages of the ring
_Q_ND = {32: 544, 64: 576, 96: 576, 128: 512, 256: 512, 288: 576, 384: 768}


def _q_edge_operands(seed, B, nd, width, qb, dtype):
    """Random K3 operands with an all-zero block (scale 0) in row 0 and in
    column 5, a row and a column that quantize to +-127 in every block, a
    -0.0 and a NaN bias column."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, nd), generator=gen, device="cuda")
    W = torch.randn((nd, width), generator=gen, device="cuda") * 0.05
    b = torch.randn((width,), generator=gen, device="cuda") * 0.01
    sign = torch.where(torch.arange(nd, device="cuda") % 3 == 0, -1.0, 1.0)
    x[-1] = 3.0 * sign                       # +-127 after quantization
    W[:, 7] = 0.25 * sign
    x[0, :qb] = 0.0                          # an all-zero block: scale 0
    W[qb:2 * qb, 5] = 0.0
    b[11] = -0.0
    b[13] = float("nan")
    return x.to(dtype), W.to(dtype), b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("qb", [32, 64, 96, 128, 256, 288, 384])
@pytest.mark.parametrize("width", [4096 + 8, 2 ** 15 + 8])
@pytest.mark.parametrize("B", [1, 3, 130, 4096])
def test_fused_topk_q_kernel_tile_edges_bitwise_match_plain(cuda, dtype, qb, width, B):
    """K3 on the int8 tensor-core tile, bitwise to its plain version at the
    tile's edges: rows and width off the [128, 128] tile, quant blocks of
    32 and 64 (several a stage), 96 and 288 (not whole stages), 128, 256
    and 384 (whole stages), a contraction that leaves a partial last stage,
    k 1, 32 and 128, bf16 and f32."""
    nd = _Q_ND[qb]
    x, W, b = _q_edge_operands(B * 7 + qb + width % 97, B, nd, width, qb, dtype)
    for k in (1, 32, 128):
        vals, idx = fek.fused_topk_encode(x, W, b, k, quant_block=qb)
        pv, pi = fek.fused_topk_encode_q_plain(x, W, b, k, qb)
        torch.cuda.synchronize()
        assert torch.equal(idx, pi), k
        assert _same_bits(vals, pv), k


def test_fused_topk_q_operands_match_the_plain_scales(cuda):
    """The kernel's operand layouts on the card: xsT is the plain
    quantization's xs transposed (padded rows zero), wqT its wq transposed,
    ws its ws."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((130, 512), generator=gen, device="cuda").to(torch.bfloat16)
    W = torch.randn((512, 1032), generator=gen, device="cuda").to(torch.bfloat16)
    xq, xsT, wqT, ws = fek.q_operands(x, W, 128)
    pxq, pxs, pwq, pws = (t.cpu() for t in fek.quant.quantize_contraction(x.cpu(), W.cpu(), 128))
    assert xsT.shape == (4, 132) and not bool(xsT[:, 130:].any())
    assert torch.equal(xsT[:, :130].cpu().view(torch.int32), pxs.t().contiguous().view(torch.int32))
    assert torch.equal(xq.cpu(), pxq) and torch.equal(wqT.cpu(), pwq.t())
    assert torch.equal(ws.cpu().view(torch.int32), pws.contiguous().view(torch.int32))
    assert wqT.is_contiguous() and xsT.is_contiguous() and ws.is_contiguous()


def test_fused_topk_q_kernel_counts_its_launches(cuda):
    x, W, b = _q_edge_operands(0, 8, 256, 1024, 128, torch.bfloat16)
    before = (fek.fused_topk_encode_q.launches, fek.fused_topk_encode.launches)
    fek.fused_topk_encode(x, W, b, 16, quant_block=128)
    fek.fused_topk_encode_q(x, W, b, 16, 128)
    torch.cuda.synchronize()
    assert (fek.fused_topk_encode_q.launches, fek.fused_topk_encode.launches) == (
        before[0] + 2, before[1])


def _tile_edge_operands(seed, B, nd, width, dtype, bias=None):
    """Exact operands at the bf16 tensor-core tile's edges: every column
    doubled half the width on (ties at every threshold, the pair in other
    tiles), -0.0 in x and in the bias, a NaN bias column (random bias)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-2, 3, (B, nd), generator=gen, device="cuda").float()
    W = torch.randint(-2, 3, (nd, width), generator=gen, device="cuda").float()
    b = (torch.randint(-8, 9, (width,), generator=gen, device="cuda").float() if bias is None
         else torch.full((width,), bias, device="cuda"))
    half = width // 2
    W[:, half:] = W[:, :half]
    b[half:] = b[:half]
    if B >= 3:
        x[2] = -0.0
    if bias is None:
        b[200] = -0.0
        b[300] = float("nan")
    return x.to(dtype), W.to(dtype), b


@pytest.mark.parametrize("B", [1, 3, 130])
@pytest.mark.parametrize("k", [1, 32, 128])
def test_fused_topk_tile_edges_bitwise_match_plain(cuda, B, k):
    """bf16 K2 on the tensor-core tile: rows, contraction (4104, not a
    multiple of the 64-deep TMA box) and width (2^15 + 8) off the tile,
    with a NaN row."""
    x, W, b = _tile_edge_operands(B * 131 + k, B, 4104, 2 ** 15 + 8, torch.bfloat16)
    if B >= 3:
        x[1] = float("nan")
    before = fek.fused_topk_encode.launches
    vals, idx = fek.fused_topk_encode(x, W, b, k)
    pv, pi = fek.fused_topk_encode_plain(x, W, b, k)
    torch.cuda.synchronize()
    assert fek.fused_topk_encode.launches == before + 1
    assert torch.equal(idx, pi)
    assert _same_bits(vals, pv)


@pytest.mark.parametrize("B", [1, 3, 130])
@pytest.mark.parametrize("bias", [None, 3.0])
def test_fused_batchtopk_tile_edges_bitwise_match_plain(cuda, B, bias):
    """bf16 K4 on the tensor-core tile at the same edges; a positive bias
    everywhere must not make the padded rows of the last row block count."""
    x, W, b = _tile_edge_operands(B * 17 + int(bias or 0), B, 4104, 2 ** 15 + 8,
                                  torch.bfloat16, bias)
    kk = fek.batchtopk_budget(B, W.shape[1], 32)
    kth = fek.fused_batchtopk_select(x, W, b, kk)
    want = fek.fused_batchtopk_select_plain(x, W, b, kk)
    torch.cuda.synchronize()
    assert int(kth) == int(want), (int(kth), int(want))
    assert _same_bits(fek.fused_batchtopk_emit(x, W, b, kth),
                      fek.fused_batchtopk_emit_plain(x, W, b, want))


def test_bf16_tile_rejects_what_tma_cannot_load(cuda):
    b = torch.zeros(1024, device="cuda")
    x = torch.zeros((4, 4100), device="cuda", dtype=torch.bfloat16)
    W = torch.zeros((4100, 1024), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="nd divisible by 8.*nd=4100"):
        fek.fused_topk_encode(x, W, b, 8)
    with pytest.raises(ValueError, match="nd divisible by 8.*nd=4100"):
        fek.fused_batchtopk_encode(x, W, b, 8)
    W = torch.zeros(256 * 1024 + 1, device="cuda", dtype=torch.bfloat16)[1:].view(256, 1024)
    x = torch.zeros((4, 256), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned W2"):
        fek.fused_topk_encode(x, W, b, 8)
    with pytest.raises(ValueError, match="aligned W2"):
        fek.fused_batchtopk_select(x, W, b, 8)


def test_fused_kernels_reject_unsupported_shapes(cuda):
    x = torch.zeros((4, 256), device="cuda")
    W, b = torch.zeros((256, 1024), device="cuda"), torch.zeros(1024, device="cuda")
    with pytest.raises(ValueError, match="quant block"):
        fek.fused_topk_encode(x, W, b, 8, quant_block=100)
    with pytest.raises(ValueError, match="k <="):
        fek.fused_topk_encode(x, W, b, 129, quant_block=128)
    with pytest.raises(ValueError, match="divisible by 8"):
        fek.fused_batchtopk_encode(x, torch.zeros((256, 1001), device="cuda"),
                                   torch.zeros(1001, device="cuda"), 4)
    with pytest.raises(ValueError, match="divisible by 16"):
        fek.fused_batchtopk_encode(torch.zeros((4, 120), device="cuda"),
                                   torch.zeros((120, 1024), device="cuda"), b, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fek.fused_batchtopk_select(x.half(), W.half(), b, 4)


def test_fused_tiers_train_on_the_card(cuda):
    """BatchTopK under fused_encoder='on' (K4; AuxK steps dense) and TopK
    with quant_encoder (K3 on bare steps) train on the card."""
    base = dict(d_in=256, dict_size=4096, batch_size=256, topk_k=16, l1_coeff=0.0,
                num_tokens=256 * 4, log_backend="null", fused_encoder="on")
    for kw, counters in (
            (dict(activation="batchtopk"), (fek.fused_batchtopk_select, fek.fused_batchtopk_emit)),
            (dict(activation="topk", sparse_bwd="on", quant_encoder=True, quant_block=256,
                  aux_k=32, aux_every=2, aux_dead_steps=1), (fek.fused_topk_encode_q,))):
        before = [c.launches for c in counters]
        tr = Trainer(CrossCoderConfig(**base, **kw), device="cuda")
        for _ in range(3):
            assert torch.isfinite(tr.step()["loss"])
        assert all(c.launches > n for c, n in zip(counters, before))


def _scatter_case(case, dtype, m):
    """``(coeff, idx, rows, n_out)`` on the card for one K10 edge case."""
    gen = torch.Generator(device="cuda").manual_seed(len(case) + m)
    T = sparse_grad._T
    if case.startswith("auxk"):                        # the AuxK filler, auxk<dead latents>
        from crosscoder_tpu_torch.models.crosscoder import _exact_topk_indices

        B, H, k_aux = 4096, 2 ** 14, 64
        h = torch.randn((B, H), generator=gen, device="cuda")
        dead = torch.zeros(H, dtype=torch.bool, device="cuda")
        dead[torch.randperm(H, generator=gen, device="cuda")[:int(case[4:])]] = True
        idx = _exact_topk_indices(torch.where(dead[None, :], h, torch.finfo(h.dtype).min), k_aux)
        coeff = torch.where(dead[idx], torch.gather(h, 1, idx), 0.0)
        n_out = H
    elif case == "one destination":
        coeff = torch.randn((4096, 8), generator=gen, device="cuda")
        idx = torch.full((4096, 8), 1234, dtype=torch.int32, device="cuda")
        n_out = 2 ** 14
    elif case == "T and T+1":
        coeff = torch.randn((T + 1, 4), generator=gen, device="cuda")
        idx = torch.randint(0, 500, (T + 1, 4), generator=gen, device="cuda", dtype=torch.int32)
        idx[:, 0] = 40                                 # T + 1 pairs: hot
        idx[:T, 1] = 41                                # T pairs: cold
        idx[T, 1] = 7
        n_out = 500
    else:                                              # "mixed"
        coeff = torch.randn((600, 16), generator=gen, device="cuda")
        idx = torch.randint(0, 1000, (600, 16), generator=gen, device="cuda", dtype=torch.int32)
        idx[:, 0] = 70                                 # hot, in the group of cold rows 64..95
        idx[:400, 1] = 75                              # a second hot row there
        idx[0, 2], idx[1, 2], idx[2, 2] = -1, 1000, 2 ** 20   # dropped
        coeff[:, 3] = 0.0                              # zero coefficients beside inf and NaN
        n_out = 1000                                   # not a multiple of the row group
    rows = torch.randn((coeff.shape[0], m), generator=gen, device="cuda")
    rows[5, :7] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, 0.0, 1e38,
                                -1e38])
    if dtype == torch.bfloat16:
        rows = rows.to(dtype)
        rows.view(torch.int16)[6, 1] = -64             # a negative NaN
    return coeff, idx, rows, n_out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,m", [("auxk0", 4608), ("auxk5", 4608), ("auxk63", 4608),
                                    ("one destination", 4608), ("T and T+1", 4736),
                                    ("mixed", 128), ("mixed", 130), ("mixed", 4608),
                                    ("mixed", 4736)])
def test_scatter_kernel_work_list_edges_bitwise_match_plain(cuda, dtype, case, m):
    """K10's work list: the AuxK filler (0, 5, 63 dead latents of 2^14,
    4096 x 64 pairs), one destination taking every pair, destinations at
    T and T + 1 pairs, hot and cold rows in one 32-row group, zero
    coefficients beside +-inf and NaN, indices -1 and past n_out, m not a
    multiple of 4 (the element-by-element path) and n_out not a multiple
    of 32."""
    coeff, idx, rows, n_out = _scatter_case(case, dtype, m)
    before = sparse_grad.scatter_add_rows.launches
    got = sparse_grad.scatter_add_rows(coeff, idx, rows, n_out)
    want = sparse_grad.scatter_add_rows_plain(coeff, idx, rows, n_out)
    assert sparse_grad.scatter_add_rows.launches == before + 1
    assert _same_bits(got, want)


@pytest.mark.parametrize("case,m", [("auxk0", 4608), ("auxk63", 4608), ("one destination", 4608),
                                    ("T and T+1", 4736), ("mixed", 130)])
def test_scatter_work_list_kernel_matches_plain(cuda, case, m):
    """K10's list builder on the card writes the plain version's items."""
    coeff, idx, _, n_out = _scatter_case(case, torch.float32, m)
    dst, _, _ = sparse_grad.sorted_pairs(coeff, idx, n_out)
    assert torch.equal(sparse_grad.work_list(dst, n_out), sparse_grad.work_list_plain(dst, n_out))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [4096 * 8 + 3, 8 * 1024 * 1024 + 5, 7])
@pytest.mark.parametrize("aligned", [True, False])
def test_batchtopk_emit_kernel_bitwise_matches_plain(cuda, dtype, n, aligned):
    """The K9 emit on n not a multiple of 8 or 4 (the tail past the last
    vector), an unaligned view (vec = 0), NaN of both signs, -0.0 and +inf;
    one launch a call."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    base = (torch.randint(-40, 41, (n + 1,), generator=gen, device="cuda").float() / 4).to(dtype)
    h = base[:n] if aligned else base[1:]
    bits = h.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
    h[0], h[1], h[2] = float("inf"), -0.0, float("nan")
    h[-1] = float("inf")
    bits[3] = -64 if dtype == torch.bfloat16 else -4194304     # a negative NaN
    assert (h.data_ptr() % 16 == 0) == aligned
    for thr in (0.0, 0.5, 3.0):
        kth = torch.tensor([topk_pallas.fixed_threshold_pattern(thr, dtype)], device="cuda")
        before = topk_pallas.batchtopk_emit.launches
        got = topk_pallas.batchtopk_emit(h, kth)
        assert topk_pallas.batchtopk_emit.launches == before + 1
        assert _same_bits(got, topk_pallas.batchtopk_emit_plain(h, kth))


def _drain_rows(seed, R, W, dtype, k):
    """Rows for K8: random signs at a density that varies by row, so rows
    hold no positive, fewer than k, exactly k, about 2k and half the row;
    a row with exactly k positives, rows past k whose last positive lies
    in each eighth of the row (so in each part of any split), NaN of both
    signs, -0.0 and +inf."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((R, W), generator=gen, device="cuda")
    dens = torch.tensor([0.0, 0.5 * k / W, k / W, 2.0 * k / W, 0.5], device="cuda")
    keep = torch.rand((R, W), generator=gen, device="cuda") < dens[torch.arange(R, device="cuda")
                                                                   % 5][:, None]
    f = torch.where(keep, h, torch.zeros((), device="cuda"))
    if R > 1 and W >= k:
        f[1] = -1.0
        f[1, torch.randperm(W, generator=gen, device="cuda")[:k]] = 2.0      # exactly k
    for i in range(8):
        r = 2 + i
        if r < R:
            end = max(1, (i + 1) * W // 8)
            f[r, end:] = -1.0                                               # last positive in
            f[r, :end] = torch.rand(end, generator=gen, device="cuda") + 0.5  # eighth i
    if R > 10 and W > 6:
        f[10, 1], f[10, 2], f[10, 4], f[10, 5] = float("nan"), -0.0, float("inf"), 3.0
    f = f.to(dtype)
    if R > 10 and W > 6:
        f.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)[10, 3] = -64  # -NaN
    return f


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W", [1, 7, 8, 255, 256, 257, 2 ** 15, 2 ** 17 + 8])
@pytest.mark.parametrize("R", [1, 3, 4096])
def test_sparsify_kernel_routes_bitwise_match_plain(cuda, dtype, W, R):
    """K8 on both its routes at their edges, bitwise against the plain
    version: k 1, 32, 128 and past the split route's staging limit, rows
    past k whose last positive lies in each part; one launch a call,
    counted on the route :func:`sparsify_plan` names."""
    for k in (1, 32, 128, topk_pallas._SPLIT_MAX_K + 1):
        f = _drain_rows(R * 7 + W + k, R, W, dtype, k)
        route = topk_pallas.sparsify_plan(W, k, dtype)[0]
        before = (topk_pallas.sparsify.launches, dict(topk_pallas.sparsify.by_route))
        vals, idx = topk_pallas.sparsify(f, k)
        pv, pi = topk_pallas.sparsify_plain(f, k)
        torch.cuda.synchronize()
        assert _same_bits(vals, pv) and torch.equal(idx, pi), (k, route)
        assert topk_pallas.sparsify.launches == before[0] + 1
        assert topk_pallas.sparsify.by_route[route] == before[1][route] + 1
        del f, vals, idx, pv, pi


def _quant_rows(seed, R, d, block, dtype):
    """Rows for K11: random normal x 7, an all-zero block, exact half-way
    quotients (a block whose max is 127: scale 1), a NaN block."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((R, d), generator=gen, device="cuda") * 7
    x[0, :block] = 0.0
    if R > 1:
        x[1, :block] = torch.arange(block, device="cuda") % 20 - 9.5
        x[1, 0] = 127.0
    if R > 2:
        x[2, block + 3 if d > block else 3] = float("nan")
    return x.to(dtype)


def _same_quant(a, b):
    (q, s), (pq, ps) = a, b
    return torch.equal(q, pq) and torch.equal(torch.isnan(s), torch.isnan(ps)) and torch.equal(
        s.nan_to_num(0.0).view(torch.int32), ps.nan_to_num(0.0).view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [1, 3, 8184, 32768])
@pytest.mark.parametrize("d", [2304, 4608])
@pytest.mark.parametrize("block", [8, 32, 256])
def test_quantize_rows_routes_bitwise_match_plain(cuda, dtype, R, d, block):
    """K11's row route on contiguous rows and its column route on the
    transposed view of a [d, R] tensor, both bitwise against the plain
    version (the column route also against the row route on the copy);
    zero and NaN blocks, R not a multiple of the column tile."""
    x = _quant_rows(R + d + block, R, d, block, dtype)
    before = dict(quant.quantize_rows.by_route)
    got = quant.quantize_rows(x, block)
    assert _same_quant(got, quant.quantize_blocks(x, block))
    xt = x.t().contiguous().t()                        # the same values as a transposed view
    assert quant.quantize_route(xt) == ("column" if R > 1 else "row")
    col = quant.quantize_rows(xt, block)
    torch.cuda.synchronize()
    assert col[0].is_contiguous() and col[1].is_contiguous()
    assert _same_quant(col, got)
    assert _same_quant(col, quant.quantize_blocks(xt, block))
    assert quant.quantize_rows.by_route["row"] == before["row"] + (1 if R > 1 else 2)
    assert quant.quantize_rows.by_route["column"] == before["column"] + (1 if R > 1 else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("block", [96, 512, 2304])
def test_quantize_rows_wide_and_odd_blocks_bitwise_match_plain(cuda, dtype, block):
    """Blocks that are not a power of two (lanes a unit below the chunk
    count) and blocks past the registers (the row route's second sweep,
    the column route's several 256-row stretches), both routes."""
    x = _quant_rows(block, 1000, 4608, block, dtype)
    want = quant.quantize_blocks(x, block)
    assert _same_quant(quant.quantize_rows(x, block), want)
    assert _same_quant(quant.quantize_rows(x.t().contiguous().t(), block), want)


def test_quantize_rows_column_route_reads_in_place(cuda):
    """``quantize_rows(W.t())``, as the int8 encoder calls it, launches the
    column route once a call and allocates nothing but its outputs: no
    transposed copy of W."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    W = torch.randn((4608, 32768), generator=gen, device="cuda").to(torch.bfloat16)
    quant.quantize_rows(W.t(), 256)                    # built and loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = (quant.quantize_rows.launches, quant.quantize_rows.by_route["column"])
    for _ in range(3):
        q, s = quant.quantize_rows(W.t(), 256)
        del q, s
    torch.cuda.synchronize()
    assert quant.quantize_rows.launches == before[0] + 3
    assert quant.quantize_rows.by_route["column"] == before[1] + 3
    outputs = 32768 * 4608 + 32768 * 18 * 4
    assert torch.cuda.max_memory_allocated() - base < outputs + (4 << 20)   # a copy: 302 MB

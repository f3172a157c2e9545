"""The kernels under the trainer's recovery and numerics paths, on the card: O1
(``csrc/adam_update.cu``) over bf16 masters beside an f32 ``log_theta``
in one launch, bitwise against its plain version; and the
``sparse_decode`` selection through the mask (K5 for bf16 rows, K7 for
wider rows) and the K8 drain, against the same function on the plain
versions. Every test needs a CUDA device and skips without one; the file
imports no JAX:

    python -m pytest -m cuda tests/test_torch_recovery_cuda.py

Bars: bitwise (each kernel rounds as its plain version does)."""

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.ops import topk_pallas as tp
from crosscoder_tpu_torch.train.state import Optimizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("master", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("norm_at", [0.5, 4.0], ids=["below_clip", "above_clip"])
@pytest.mark.parametrize("H", [1000, 4096 + 3])
def test_adam_update_mixed_leaves_bitwise(cuda, master, norm_at, H):
    gen = torch.Generator(device="cuda").manual_seed(H)
    shapes = {"W_enc": (2, 64, H), "W_dec": (H, 2, 64), "b_enc": (H,), "b_dec": (2, 64),
              "log_theta": (H,)}

    def leaves(scale, positive=False):
        out = {}
        for k, s in shapes.items():
            t = torch.randn(s, generator=gen, device="cuda") * scale
            out[k] = (t.abs() if positive else t).to(torch.float32 if k == "log_theta" else master)
        return out

    p, g, m, v = leaves(0.1), leaves(1.0), leaves(0.01), leaves(1e-4, positive=True)
    n0 = float(Optimizer.global_norm(g))
    g = {k: (t.float() * (norm_at / n0)).to(t.dtype) for k, t in g.items()}
    norm = Optimizer.global_norm(g)
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.271, bc2=0.002997,
              step_size=-1e-3)
    outs = [tuple({k: torch.empty_like(t) for k, t in p.items()} for _ in range(3))
            for _ in range(2)]
    before = adam.adam_update.launches
    adam.adam_update(p, g, m, v, norm, out=outs[0], **kw)
    assert adam.adam_update.launches == before + 1           # one launch for every leaf
    adam.adam_update_plain(p, g, m, v, norm, out=outs[1], **kw)
    for a, b in zip(*outs):
        for k in p:
            assert a[k].dtype == p[k].dtype
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
    # in place as the trainer's donated step
    want = outs[1]
    adam.adam_update(p, g, m, v, norm, **kw)
    for got, w in zip((p, m, v), want):
        for k in p:
            assert torch.equal(_bits(got[k]), _bits(w[k])), k


def _plain_kernels(monkeypatch):
    monkeypatch.setattr(tp, "topk_mask", tp.topk_plain)
    monkeypatch.setattr(tp, "topk_mask_f32", tp.topk_plain)
    monkeypatch.setattr(tp, "topk_chunked", tp.topk_chunked_plain)
    monkeypatch.setattr(tp, "sparsify", tp.sparsify_plain)


@pytest.mark.parametrize("dict_size,enc_dtype,route", [(2 ** 15, "bf16", "K5"),
                                                       (2 ** 17, "bf16", "K7"),
                                                       (2 ** 14, "fp32", "K6")])
def test_sparse_decode_selection_on_the_mask_and_drain(cuda, dict_size, enc_dtype, route,
                                                       monkeypatch):
    cfg = CrossCoderConfig(d_in=64, n_models=2, dict_size=dict_size, topk_k=32,
                           activation="topk", l1_coeff=0.0, sparse_decode=True,
                           enc_dtype=enc_dtype)
    dt = cc.dtype_of(enc_dtype)
    params = cc.init_params(cfg, seed=1, device="cuda", dtype=dt)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((256, 2, 64), generator=gen, device="cuda").to(dt)
    # rows 0-7: a few positives, column 0 among them (the drain's padding slots)
    params["b_enc"][:] = 0
    x[:8] = 0
    params["b_enc"][[0, 7, 300]] = 1.0
    assert tp.topk_route(dict_size, 32, dt) == route
    counts = (tp.topk.launches, tp.topk_mask_f32.launches, tp.topk_chunked.launches,
              tp.sparsify.launches)
    vals, idx = cc.topk_vals_idx(params, x, cfg)
    after = (tp.topk.launches, tp.topk_mask_f32.launches, tp.topk_chunked.launches,
             tp.sparsify.launches)
    assert after[3] == counts[3] + 1
    slot = {"K5": 0, "K6": 1, "K7": 2}[route]
    assert after[slot] == counts[slot] + 1
    torch.cuda.synchronize()
    with monkeypatch.context() as mp:
        _plain_kernels(mp)
        pvals, pidx = cc.topk_vals_idx(params, x, cfg)
    assert torch.equal(idx, pidx)
    assert torch.equal(_bits(vals), _bits(pvals))
    assert int((vals[:8] > 0).sum(-1).max()) <= 3
    recon, _, _ = cc.sparse_topk_forward(params, x, cfg)
    with monkeypatch.context() as mp:
        _plain_kernels(mp)
        precon, _, _ = cc.sparse_topk_forward(params, x, cfg)
    assert torch.equal(recon, precon)

"""The analysis path on the card: the CE-recovered eval through the f32
TopK mask kernel (K6) bitwise against its re-run with the plain version,
and the LM forward with logits on the card against the CPU forward. Every
test here needs a CUDA device and skips without one; the file imports no
JAX, so the card's machine runs it as is:

    python -m pytest --noconftest -m cuda tests/test_torch_analysis_cuda.py

Tolerances: the CE tensor bitwise (the kernel and the plain version
select the same mask, and nothing else differs between the runs); the
fp32 logits 1e-4 absolute against the CPU (cuBLAS and the CPU sum in
other orders)."""

import numpy as np
import pytest
import torch

from crosscoder_tpu_torch.analysis import ce_eval
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.ops import topk_pallas

pytestmark = pytest.mark.cuda

HOOK = "blocks.2.hook_resid_pre"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # parity in full fp32
    torch.backends.cudnn.allow_tf32 = False


def _tokens(n, seed=0):
    t = np.random.default_rng(seed).integers(3, 257, size=(n, 24))
    t[:, 0] = 2
    return t


def test_ce_recovered_on_the_card_bitwise_to_plain(cuda, monkeypatch):
    """A 1024-latent TopK crosscoder (k 32) on f32 rows takes K6: one
    launch per chunk, and the chunk's [n_models, 3] CEs equal the plain
    re-run's bit for bit."""
    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    cfg = CrossCoderConfig(d_in=32, n_models=2, dict_size=1024, hook_point=HOOK,
                           activation="topk", topk_k=32, enc_dtype="fp32")
    assert topk_pallas.topk_route(cfg.dict_size, cfg.topk_k, torch.float32) == "K6"
    ccp = cc.fold_scaling_factors(cc.init_params(cfg, seed=3, device="cuda"), [0.7, 1.4])
    rec = ce_eval.crosscoder_reconstruct_fn(ccp, cfg)
    tok = torch.as_tensor(_tokens(4), device="cuda")
    before = topk_pallas.topk_mask_f32.launches
    got = ce_eval.chunk_ces(params, rec, tok, lm_cfg, HOOK)
    assert topk_pallas.topk_mask_f32.launches == before + 1
    with monkeypatch.context() as m:
        m.setattr(topk_pallas, "topk_mask_f32", topk_pallas.topk_plain)
        want = ce_eval.chunk_ces(params, rec, tok, lm_cfg, HOOK)
    assert got.shape == (2, 3) and torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    before = topk_pallas.topk_mask_f32.launches
    m = ce_eval.get_ce_recovered_metrics(_tokens(5, 1), lm_cfg, params, HOOK, rec, chunk=2)
    assert topk_pallas.topk_mask_f32.launches == before + 3            # chunks of 2, 2, 1
    assert np.isfinite(list(m.values())).all()
    ident = ce_eval.get_ce_recovered_metrics(_tokens(5, 1), lm_cfg, params, HOOK,
                                             lambda rows: rows, chunk=2)
    assert ident["ce_recovered_A"] == ident["ce_recovered_B"] == 1.0


def test_forward_on_the_card_matches_the_cpu(cuda):
    lm_cfg = lm.LMConfig.tiny()
    cpu = lm.init_params(lm_cfg, seed=5, device="cpu")
    card = {"embed": cpu["embed"].cuda(), "final_norm": cpu["final_norm"].cuda(),
            "layers": {k: v.cuda() for k, v in cpu["layers"].items()}}
    tok = _tokens(3, 2)
    edits = [lm.Edit("blocks.1.hook_attn_out", lm.zero_edit)]
    for kw in ({}, {"edits": edits}):
        want, _ = lm.forward(cpu, tok, lm_cfg, capture=[HOOK], **kw)
        got, cache = lm.forward(card, tok, lm_cfg, capture=[HOOK], **kw)
        assert got.device.type == "cuda" and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)

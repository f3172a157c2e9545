"""The static correctness plane on the card: the kernel pack (every
library's probes captured and clean, the tail probes at their bars and
bitwise twice) and the step rules that run on ``cuda`` only (the fused-live
train and serve steps carry no ``[B, dict]`` tensor; the donated AuxK step
keeps every leaf; no host transfer in any variant). Every test needs a
CUDA device and skips without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_contracts_cuda.py
"""

import pytest
import torch

from crosscoder_tpu_torch.analysis.contracts import (KERNEL_RULES, STEP_RULES, kernel_safety,
                                                     run_kernel_probes, run_rules, step_rules)
from crosscoder_tpu_torch.ops import _build

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_the_kernel_pack_is_clean_and_covers_every_library(cuda):
    ctx = run_kernel_probes("cuda", sanitize=False)
    rep = run_rules(KERNEL_RULES, ctx)
    assert rep.ok, "\n".join(str(f) for f in rep.findings if f.severity == "error")
    assert {ln.library for ln in ctx.launches} == set(_build.kernel_names())
    assert set(rep.skipped) == set(kernel_safety.SANITIZER_RULES.values())
    tails = {p.name for p in kernel_safety.tail_probes()}
    assert set(ctx.tail_bars) == set(ctx.repeats) == tails
    assert all(ok for ok, _ in ctx.tail_bars.values()), ctx.tail_bars
    assert all(ctx.repeats.values())
    assert {ln.cluster for ln in ctx.launches if ln.probe.startswith("topk_chunked/cluster")} \
        == {2, 3, 4}


def test_the_fused_live_steps_carry_no_dense_preacts(cuda):
    ctx = step_rules.StepContext(device="cuda")
    cfg = step_rules._cfg(activation="topk", fused_encoder="on", sparse_bwd="on",
                          **step_rules._FUSED_SHAPE)
    step_rules.add_fused_live(ctx, cfg, "cuda", serve_cfg=cfg.replace(serve="on"))
    rep = run_rules(STEP_RULES, ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert set(step_rules.FUSED_RULES) <= set(rep.checked)
    assert ctx.launches["topk:fused_live"]["fused_topk_encode"] == 1
    assert ctx.launches["serve:encode_fused"] == {"fused_topk_encode": 1}


def test_the_lattice_is_clean_on_the_card(cuda):
    ctx = step_rules.build_step_context("cuda", full=True)
    rep = run_rules(STEP_RULES, ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert not rep.skipped and len(rep.checked) == len(STEP_RULES)


@pytest.mark.parametrize("kw", [dict(aux_k=8, aux_every=2), dict(aux_k=8, aux_mask_every=4),
                                dict(activation="batchtopk", enc_dtype="fp32", sparse_bwd="off")],
                         ids=["aux", "aux-cached-mask", "batchtopk-f32"])
def test_the_step_rules_hold_on_the_card(cuda, kw):
    cfg = step_rules._cfg(**{**dict(activation="topk", topk_k=8, l1_coeff=0.0, d_in=128,
                                    dict_size=1024, batch_size=192, sparse_bwd="on"), **kw})
    rec = step_rules.record_step(cfg, "cuda")
    ctx = step_rules.StepContext(device="cuda")
    ctx.add("v", rec, step_rules.train_meta(cfg, rec))
    rep = run_rules(STEP_RULES, ctx)
    assert rep.ok and not rep.findings, "\n".join(str(f) for f in rep.findings)
    assert rec.moved == [] and rec.launches.get("adam_update") == 1
